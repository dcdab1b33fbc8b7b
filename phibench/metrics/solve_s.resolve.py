"""The mean of the pipeline's timings["solve"] over the window's items
(host clock)."""

from phibench.readers import mean_timing


def read(run):
    return mean_timing(run, "solve")
