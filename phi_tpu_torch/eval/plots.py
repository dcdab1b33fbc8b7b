"""Figure rendering for benchmark matrices — the equivalent of the
reference's data/plots/*.py matplotlib scripts (plot_edits.py etc.), reading
the same '(time, rss, edit)' CSV cells (data/plots/increasing.py:19-22).
The port's copy of `phi_tpu/eval/plots.py` (host only; matplotlib is
imported by the plotting functions, not by the module).

    python -m phi_tpu_torch.eval.plots matrix.csv fig.png [--metric 2]
"""

from __future__ import annotations

import ast
import csv


def read_matrix_csv(path: str):
    """Returns (read_names, coverages, cells) where cells[(read, cov)] =
    (time_s, rss_gb, edit_distance)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    covs = rows[0][1:]
    reads, cells = [], {}
    for row in rows[1:]:
        reads.append(row[0])
        for cov, cell in zip(covs, row[1:]):
            if cell.strip():
                cells[(row[0], cov)] = ast.literal_eval(cell)
    return reads, covs, cells


def plot_matrix(csv_path: str, out_png: str, metric: int = 2,
                ylabel: str = "edit distance", logy: bool = True) -> None:
    """One line per read set across coverages (metric: 0=time, 1=rss,
    2=edit distance), like the reference's plot_edits.py figures."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    reads, covs, cells = read_matrix_csv(csv_path)

    def _cov_key(c: str):
        try:
            return float(c.rstrip("xX"))
        except ValueError:
            return float("inf")

    covs = sorted(covs, key=_cov_key)  # CSV columns sort lexically
    fig, ax = plt.subplots(figsize=(6, 4))
    for rn in reads:
        ys = [cells[(rn, cv)][metric] for cv in covs if (rn, cv) in cells]
        xs = [cv for cv in covs if (rn, cv) in cells]
        ax.plot(xs, ys, marker="o", label=rn)
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel("coverage")
    ax.set_ylabel(ylabel)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


def plot_scaling(csv_path: str, out_png: str,
                 reference: dict[int, tuple[float, float]] | None = None
                 ) -> None:
    """Haplotype-count scaling figure from the phi-torch-scale CSV
    (n_haps, wall_s, peak_rss_gb, ...) — the reference's increasing.py
    figure. `reference` maps n_haps -> (wall_s, rss_gb) for overlay."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    n = [int(r["n_haps"]) for r in rows]
    # CSVs with the variance discipline carry wall_median_s + IQR; single-
    # observation CSVs keep wall_s
    key = "wall_median_s" if rows and "wall_median_s" in rows[0] else "wall_s"
    wall = [float(r[key]) for r in rows]
    iqr = [float(r.get("wall_iqr_s", 0) or 0) for r in rows]
    rss = [float(r["peak_rss_gb"]) for r in rows]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 4))
    if any(iqr):
        ax1.errorbar(n, wall, yerr=[x / 2 for x in iqr], marker="o",
                     capsize=3, label="PHI-TPU (median, IQR)")
    else:
        ax1.plot(n, wall, marker="o", label="PHI-TPU")
    ax2.plot(n, rss, marker="o", label="PHI-TPU")
    if reference:
        rn = sorted(reference)
        ax1.plot(rn, [reference[x][0] for x in rn], marker="s",
                 linestyle="--", label="reference PHI")
        ax2.plot(rn, [reference[x][1] for x in rn], marker="s",
                 linestyle="--", label="reference PHI")
    for ax, yl in ((ax1, "wall clock (s)"), (ax2, "peak RSS (GB)")):
        ax.set_xlabel("haplotypes")
        ax.set_ylabel(yl)
        ax.set_yscale("log")
        ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


# data/plots/increasing.csv:2 — the reference's published scaling row
REFERENCE_INCREASING = {3: (69.0, 4.5), 7: (177.0, 13.0), 13: (419.0, 28.4),
                        25: (1356.0, 63.0), 49: (4828.0, 133.3)}


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="phi-torch-plots")
    p.add_argument("csv")
    p.add_argument("out_png")
    p.add_argument("--metric", type=int, default=2,
                   help="0=time, 1=rss, 2=edit distance [2]")
    p.add_argument("--ylabel", default="edit distance")
    p.add_argument("--linear", action="store_true")
    a = p.parse_args(argv)
    plot_matrix(a.csv, a.out_png, a.metric, a.ylabel, logy=not a.linear)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
