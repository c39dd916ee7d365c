"""Fixture sync-in-loop sites in the device layer loops."""

import torch


def _fetch(*xs):
    return [x.cpu() for x in xs]  # clean: a comprehension is not a for/while body


def run_search(frontier):
    while _fetch(frontier.any())[0]:  # expect: sync-in-loop
        n = frontier.sum().item()  # expect: sync-in-loop
        frontier = frontier[n:]
    for layer in range(3):
        rows = frontier.tolist()  # expect: sync-in-loop
        torch.cuda.synchronize()  # expect: sync-in-loop
        print(layer, rows)
    return frontier


def silenced(frontier):
    for _ in range(3):
        # verifylint: disable=sync-in-loop
        frontier = frontier[: frontier.sum().item()]
    return frontier


def once(frontier):
    n = frontier.sum().item()  # clean: not in a loop
    for row in frontier.cpu():  # clean: a for's iter runs once
        print(row)
    for _ in range(2):
        frontier = frontier.to("cpu", non_blocking=True)  # clean: not a sync
    else:
        n = frontier.sum().item()  # clean: a loop's else runs once
    return n
