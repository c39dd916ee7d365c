"""The least time the card can take for a kernel's work, and the card's
peaks."""
