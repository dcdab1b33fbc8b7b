"""Benchmark matrix runner — the equivalent of the reference's
data/run_batch_*.py + postprocessing*.py pipeline, in-process (the port's
copy of `phi_tpu/eval/batch.py`, on the port's pipeline and `device`).

Runs the pipeline over a (reads x coverage) matrix and emits CSV rows shaped
like data/plots/*.csv: each cell is "(real_time_s, peak_RSS_GB, edit_dist)"
(decoding per data/plots/increasing.py:19-22)."""

from __future__ import annotations

import csv
import dataclasses

from phi_tpu_torch import logging as plog
from phi_tpu_torch.config import Options
from phi_tpu_torch.eval.edits import edit_stats


@dataclasses.dataclass
class MatrixCell:
    read_name: str
    coverage: str
    real_time_s: float          # median over n_runs
    peak_rss_gb: float
    edit_distance: int
    recombinations: int
    n_runs: int = 1
    time_iqr_s: float = 0.0
    raw_times_s: list[float] = dataclasses.field(default_factory=list)


def run_matrix(gfa_path: str,
               cells: list[tuple[str, str, str, str]],
               opt: Options | None = None,
               out_csv: str | None = None,
               target_runs: int = 5, device="cuda") -> list[MatrixCell]:
    """cells: (read_name, coverage_label, reads_path, truth_fasta_path).

    Each cell is measured median-of-N (N>=target_runs when a single run is
    cheap; see eval/stats.py for the variance rationale). Every run is
    `pipeline.run_pipeline` on `device`."""
    from phi_tpu_torch import pipeline
    from phi_tpu_torch.eval.edits import _read_fasta_first_seq
    from phi_tpu_torch.eval.stats import run_stats
    device = pipeline.resolve_device(device)
    opt = opt or Options()
    results: list[MatrixCell] = []
    for read_name, cov, reads_path, truth_path in cells:
        res, st_t = run_stats(
            lambda: pipeline.run_pipeline(gfa_path, reads_path, None, opt,
                                          device=device),
            target_runs=target_runs)
        truth = _read_fasta_first_seq(truth_path)
        st = edit_stats(res.sequence, truth)
        results.append(MatrixCell(
            read_name=read_name, coverage=cov,
            real_time_s=st_t["median_s"],
            peak_rss_gb=plog.peakrss_gb(), edit_distance=st.edit_distance,
            recombinations=res.recombination_count,
            n_runs=st_t["n_runs"], time_iqr_s=st_t["iqr_s"],
            raw_times_s=st_t["raw_s"]))
    if out_csv:
        write_matrix_csv(results, out_csv)
        write_matrix_stats_csv(results, out_csv + ".stats.csv")
    return results


def write_matrix_stats_csv(results: list[MatrixCell], path: str) -> None:
    """Long-format companion to the data/plots-shaped grid: one row per
    cell with the full dispersion (n_runs, median, IQR, raw runs kept)."""
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["read", "coverage", "n_runs", "time_median_s",
                     "time_iqr_s", "time_min_s", "time_max_s",
                     "peak_rss_gb", "edit_distance", "recombinations",
                     "raw_times_s"])
        for c in results:
            raw = c.raw_times_s or [c.real_time_s]
            wr.writerow([c.read_name, c.coverage, c.n_runs,
                         f"{c.real_time_s:.3f}", f"{c.time_iqr_s:.3f}",
                         f"{min(raw):.3f}", f"{max(raw):.3f}",
                         f"{c.peak_rss_gb:.2f}", c.edit_distance,
                         c.recombinations,
                         " ".join(f"{t:.3f}" for t in raw)])


def write_matrix_csv(results: list[MatrixCell], path: str) -> None:
    """Same cell encoding as data/plots/*.csv: '(time, rss, edit)' strings in
    a reads x coverage grid."""
    reads = sorted({r.read_name for r in results})
    covs = sorted({r.coverage for r in results})
    grid = {(r.read_name, r.coverage): r for r in results}
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["Reads"] + covs)
        for rn in reads:
            row = [rn]
            for cv in covs:
                c = grid.get((rn, cv))
                row.append("" if c is None else
                           f"({c.real_time_s:.1f}, {c.peak_rss_gb:.2f}, {c.edit_distance})")
            wr.writerow(row)


def fastq_open(path: str, mode: str = "rt"):
    """Open a FASTQ, gzip-aware by extension."""
    import gzip
    return (gzip.open if path.endswith(".gz") else open)(path, mode)


def fastq_records(path: str):
    """Yield 4-line FASTQ records (lists of raw lines) from a (gzipped)
    file; stops at EOF or a truncated final record."""
    with fastq_open(path) as f:
        while True:
            rec = [f.readline() for _ in range(4)]
            if not rec[0] or not rec[3]:
                break
            yield rec


def downsample_fastq(in_path: str, out_path: str, fraction: float,
                     seed: int = 11) -> int:
    """Bernoulli per-read downsampling of a (gzipped) FASTQ — the native
    stand-in for the reference's `seqkit sample -p` coverage titration
    (data/preprocess.py:85-109). Returns the number of reads kept."""
    import numpy as np
    rng = np.random.default_rng(seed)
    kept = 0
    with fastq_open(out_path, "wt") as out:
        for rec in fastq_records(in_path):
            if rng.random() < fraction:
                out.writelines(rec)
                kept += 1
    return kept
