"""The mean of the pipeline's timings["sketch_haps_hits_cuckoo"] over the window's items
(host clock). None where the program records no such span."""

from phibench.readers import mean_timing


def read(run):
    return mean_timing(run, "sketch_haps_hits_cuckoo")
