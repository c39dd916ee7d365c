"""verdicts_per_s.illegal: ``e2e/verdicts_per_s.py``'s rate, read per layer
in the cells where the host's pace, which moves from machine to machine,
sets it too far for an end-to-end bound."""


def read(run):
    return sum(r.decided for r in run.requests) / run.window_s
