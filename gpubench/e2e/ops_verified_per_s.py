"""Checked operations (the prepared history's, definite failures left out)
of every decided history of the window, over the window's time."""


def read(run):
    return sum(r.checked_ops for r in run.requests if r.decided) / run.window_s
