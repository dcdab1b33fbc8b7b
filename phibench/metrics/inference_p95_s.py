"""The 95th percentile, by nearest rank, of every inference wall in the
window (host clock)."""

from phibench.readers import done, nearest_rank


def read(run):
    return nearest_rank([r["wall_s"] for r in done(run)], 95)
