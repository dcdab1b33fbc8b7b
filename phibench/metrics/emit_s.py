"""The mean of the pipeline's timings["emit"] over the window's items
(host clock)."""

from phibench.readers import mean_timing


def read(run):
    return mean_timing(run, "emit")
