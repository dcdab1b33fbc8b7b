"""Percent of the traced window (the items' ranges) in which nothing ran
on the card: 1 - union of the profiler's device intervals / window."""

from phibench.readers import idle_share


def read(run):
    return idle_share(run)
