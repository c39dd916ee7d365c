"""Seconds from the process's start to the first timed request: imports,
the CUDA context, loading the fold kernel (building it, in a fresh
checkout), making the pool of histories, and the warm-up request."""


def read(run):
    return run.setup_s
