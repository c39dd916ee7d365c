"""Set-up, the measured window, the trace, the judge and the result line of
one run of a cell."""
