"""The mean of the pipeline's timings["load_graph"] over the window's items
(host clock)."""

from phibench.readers import mean_timing


def read(run):
    return mean_timing(run, "load_graph")
