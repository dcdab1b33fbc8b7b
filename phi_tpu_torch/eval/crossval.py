"""Leave-one-out cross-validation over a real panel (BASELINE config 3 on
real data): each panel haplotype in turn becomes the held-out target — the
graph is subset to exclude its walk (io.subset, the chop_graph.sh:37-69
ignore-list analog), reads are sampled from its real sequence with
sequencing errors, and the inferred mosaic is scored against it. The
best-single-panel-hap baseline (the imputation floor any non-recombining
method could reach, eval/baselines.py) is scored alongside.

The port's copy of `phi_tpu/eval/crossval.py`: the pipeline and the
baseline's walk sketches run on `device`. The baseline's read spectrum is
the native scan's (`pipeline.read_spectrum`) over the fold's reads, where
the JAX package sketches a padded read batch on its device; the two
spectra are equal.

CLI: python -m phi_tpu_torch.eval.crossval -g graph.gfa [-c 1.0] [-e 0.003]
     [--device cuda]
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np


def fold_spectrum(reads: list[str], k: int, w: int):
    """The read spectrum (hi, lo) of a fold's reads, from the native scan."""
    from phi_tpu_torch.io.gfa import encode_seq
    from phi_tpu_torch.io.reads import ReadBatch
    from phi_tpu_torch.pipeline import read_spectrum
    lengths = np.array([len(r) for r in reads], np.int32)
    off = np.zeros(len(reads) + 1, np.int64)
    np.cumsum(lengths, out=off[1:])
    concat = encode_seq("".join(reads)) if reads else None
    batch = ReadBatch(lengths, [f"r{i}" for i in range(len(reads))],
                      concat=concat, off=off if reads else None)
    return read_spectrum(batch, k, w)


def leave_one_out(gfa_path: str, coverage: float = 1.0,
                  error_rate: float = 0.003, read_len: int = 150,
                  seed: int = 0, targets: list[str] | None = None,
                  opt=None, device="cuda") -> list[dict]:
    """One row per held-out walk: inferred edit, best-panel-hap edit,
    recombination count, wall time."""
    import time

    from phi_tpu_torch import pipeline
    from phi_tpu_torch.config import Options
    from phi_tpu_torch.eval.baselines import best_panel_hap
    from phi_tpu_torch.eval.edits import edit_stats
    from phi_tpu_torch.eval.synth import sample_reads
    from phi_tpu_torch.graph.pangenome import tensorize
    from phi_tpu_torch.io.gfa import read_gfa, write_gfa
    from phi_tpu_torch.io.subset import subset_panel

    device = pipeline.resolve_device(device)
    opt = opt or Options()
    g = read_gfa(gfa_path)
    full = tensorize(g)
    rows = []
    names = list(full.walk_names)
    for h, name in enumerate(names):
        if targets is not None and name not in targets:
            continue
        truth = full.path_seq(full.walk_mat[h, :full.walk_len[h]])
        rng = np.random.default_rng(seed + h)
        reads, _ = sample_reads(rng, [truth], coverage=coverage,
                                read_len=read_len, error_rate=error_rate)
        keep = [i for i in range(len(names)) if i != h]
        with tempfile.TemporaryDirectory() as d:
            sub_path = os.path.join(d, "panel.gfa")
            write_gfa(subset_panel(g, keep), path=sub_path)
            reads_path = os.path.join(d, "reads.fa")
            with open(reads_path, "w") as f:
                for i, r in enumerate(reads):
                    f.write(f">r{i}\n{r}\n")
            out = os.path.join(d, "out.fa")
            t0 = time.time()
            res = pipeline.run_pipeline(sub_path, reads_path, out, opt,
                                        device=device)
            wall = time.time() - t0
            st = edit_stats(res.sequence, truth)
            # imputation floor: the panel walk sharing the most read
            # minimizers, emitted as-is
            sub = tensorize(read_gfa(sub_path))
            spectrum = fold_spectrum(reads, opt.k, opt.w)
            bh, bseq = best_panel_hap(sub, spectrum, opt.k, opt.w, device)
            bst = edit_stats(bseq, truth)
        rows.append({
            "data": "real",  # real panel walks; reads simulated from them
            "target": name, "coverage": coverage,
            "edit": st.edit_distance, "identity": round(st.identity, 5),
            "recombinations": res.recombination_count,
            "best_hap": sub.walk_names[bh],
            "best_hap_edit": bst.edit_distance,
            "gap": round(max(0.0, res.decode.true_objective
                             - res.decode.dp_objective), 3),
            "wall_s": round(wall, 2),
        })
    return rows


def leave_one_out_grid(gfa_path: str, coverages: list[float],
                       error_rate: float = 0.003, read_len: int = 150,
                       seed: int = 0, targets: list[str] | None = None,
                       opt=None, target_runs: int = 3,
                       device="cuda") -> list[dict]:
    """Full (held-out hap) x (coverage) grid with the variance discipline:
    per cell the pipeline is repeated target_runs times (median/IQR/raw
    walls reported); edit metrics are deterministic given the read set."""
    from phi_tpu_torch.eval.stats import run_stats
    rows = []
    for cov in coverages:
        # timing: repeat the whole per-coverage leave-one-out row-set
        per_cov, st_t = run_stats(
            lambda c=cov: leave_one_out(gfa_path, c, error_rate, read_len,
                                        seed, targets, opt, device),
            target_runs=target_runs)
        n = max(len(per_cov), 1)
        for r in per_cov:
            r["wall_median_s"] = round(st_t["median_s"] / n, 3)
            r["wall_iqr_s"] = round(st_t["iqr_s"] / n, 3)
            r["n_runs"] = st_t["n_runs"]
        rows.extend(per_cov)
    return rows


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="python -m phi_tpu_torch.eval.crossval",
        description="Leave-one-out cross-validation over a panel GFA")
    ap.add_argument("-g", required=True, help="panel GFA")
    ap.add_argument("-c", default="1.0",
                    help="read coverage, or comma grid (e.g. 0.1,0.5,1)")
    ap.add_argument("-e", type=float, default=0.003, help="read error rate")
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--targets", default=None,
                    help="comma list of walk names (default: all)")
    ap.add_argument("--runs", type=int, default=3,
                    help="timing repeats per coverage (median/IQR)")
    ap.add_argument("--out-csv", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="torch device of the pipeline and the baseline's "
                         "walk sketches [cuda]")
    a = ap.parse_args(argv)
    targets = a.targets.split(",") if a.targets else None
    coverages = [float(x) for x in str(a.c).split(",")]
    try:
        if len(coverages) == 1 and a.runs <= 1:
            rows = leave_one_out(a.g, coverages[0], a.e, a.read_len, a.seed,
                                 targets, device=a.device)
        else:
            rows = leave_one_out_grid(a.g, coverages, a.e, a.read_len,
                                      a.seed, targets, target_runs=a.runs,
                                      device=a.device)
    except (ValueError, OSError, RuntimeError) as e:
        sys.stderr.write(f"[E::main] {e}\n")
        return 1
    for r in rows:
        print(json.dumps(r))
    if a.out_csv:
        import csv
        with open(a.out_csv, "w", newline="") as f:
            wtr = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            wtr.writeheader()
            wtr.writerows(rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
