"""The plain reference that decides ``correct``: the S2 stream model, its
64-bit chain hash, witness replay and an exact search, in Python and
NumPy, importing nothing of the program it judges."""
