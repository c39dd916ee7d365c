"""Histories decided per second: every verdict (OK or ILLEGAL) of the
window over the window's time, from the first request sent to the last
verdict back."""


def read(run):
    return sum(r.decided for r in run.requests) / run.window_s
