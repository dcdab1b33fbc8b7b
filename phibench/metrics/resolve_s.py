"""Wall per --load-index re-solve: the measured window over the
re-solves completed in it (host clock)."""

from phibench.readers import per_item


def read(run):
    return per_item(run)
