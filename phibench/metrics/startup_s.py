"""Child launch to run_pipeline's entry: each item's launch-to-FASTA wall
(the parent's launch to the child's FASTA on disk, host clock) minus the
pipeline's timings["total"], averaged. The traced run's profiler start is
taken out, so the number reads as in an untraced run."""

from phibench.readers import done


def read(run):
    vals = [r["to_fasta_s"] - r["timings"]["total"] for r in done(run)
            if "to_fasta_s" in r]
    return sum(vals) / len(vals) if vals else None
