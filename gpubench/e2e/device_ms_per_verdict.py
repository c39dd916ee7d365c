"""Device time a verdict costs: the duration of every device operation
(kernels, copies, fills) in a device trace of the whole window, over the
window's verdicts, in milliseconds.  What the card spends on each history,
whatever the host's pace."""


def read(run):
    n = sum(r.decided for r in run.requests)
    return 1e3 * run.device_s / n if run.device_s and n else None
