"""The mean of the pipeline's timings["load_graph_parse"] over the window's items
(host clock). None where the program records no such span."""

from phibench.readers import mean_timing


def read(run):
    return mean_timing(run, "load_graph_parse")
