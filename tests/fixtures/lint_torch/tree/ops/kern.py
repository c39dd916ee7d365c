"""Fixture: ops/ is in the sync-in-loop scope."""


def fold_all(tables):
    out = []
    for t in tables:
        out.append(t.sum().cpu())  # expect: sync-in-loop
    return out
