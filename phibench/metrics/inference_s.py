"""Wall per sample: the measured window over the inferences completed
in it (host clock; the window is the sum of the items' walls, from the call,
or the child's launch, to the FASTA on disk)."""

from phibench.readers import per_item


def read(run):
    return per_item(run)
