"""The 95th percentile (nearest rank) of a request's wall, from sending its
history to its verdict back, over every request of the window."""

import math


def read(run):
    walls = sorted(r.wall_s for r in run.requests)
    return walls[math.ceil(0.95 * len(walls)) - 1]
