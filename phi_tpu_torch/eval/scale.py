"""Scale benchmark: reference-shaped synthetic instances at the published
configs — the 49-hap x 5 Mbp headline and the progressive 3/7/13/25/49 panel
sweep (BASELINE.md, data/plots/increasing.csv analog; reference runs them via
data/run_batch_{9..13}.py + chop_graph.sh:37-69 panel subsets). The port's
copy of `phi_tpu/eval/scale.py`: the generators write byte-identical files
from the same seed into the same directory names, and the runners drive the
port's `run_pipeline` on `device`.

Instances are materialized as real files (GFA + FASTQ + truth FASTA) in a
cache directory (PHI_TPU_SCALE_CACHE) and driven through the standard
`run_pipeline` CLI path, so measured numbers cover the same surface the
reference times.

    python -m phi_tpu_torch.eval.scale --haps 3,7,13,25,49 --length 5000000 \
        --coverage 2 --out-csv scale.csv [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import sys
import tempfile

import numpy as np

from phi_tpu_torch.config import Options
from phi_tpu_torch.eval.edits import edit_stats
from phi_tpu_torch.eval.synth import sample_reads, synth_pangenome
from phi_tpu_torch.io.gfa import write_gfa

CACHE_DIR = os.environ.get("PHI_TPU_SCALE_CACHE",
                           os.path.join(tempfile.gettempdir(),
                                        "phi_tpu_scale"))


def instance_dir(n_haps: int, length: int, coverage: float, seed: int,
                 var_rate: float, error_rate: float, n_breaks: int,
                 read_len: int = 150) -> str:
    tag = (f"h{n_haps}_L{length}_c{coverage:g}_s{seed}_v{var_rate:g}"
           f"_e{error_rate:g}_b{n_breaks}")
    if read_len != 150:
        tag += f"_r{read_len}"
    return os.path.join(CACHE_DIR, tag)


def build_instance(n_haps: int, length: int = 5_000_000, coverage: float = 2.0,
                   seed: int = 0, var_rate: float = 0.01,
                   error_rate: float = 0.002, n_breaks: int = 2,
                   indel_fraction: float = 0.05,
                   read_len: int = 150) -> dict[str, str]:
    """Materialize (or reuse) a cached instance; returns its file paths.

    The read target is a recombinant mosaic of panel haplotypes with
    n_breaks switchpoints (the inference task the reference's benchmark
    exercises: infer a recombined haplotype from low-coverage reads)."""
    d = instance_dir(n_haps, length, coverage, seed, var_rate, error_rate,
                     n_breaks, read_len)
    paths = {"gfa": os.path.join(d, "graph.gfa"),
             "reads": os.path.join(d, "reads.fq.gz"),
             "truth": os.path.join(d, "truth.fa"),
             "meta": os.path.join(d, "meta.json")}
    if all(os.path.exists(p) for p in paths.values()):
        return paths
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    graph, hap_seqs = synth_pangenome(rng, length=length, n_haps=n_haps,
                                      var_rate=var_rate,
                                      indel_fraction=indel_fraction)
    breaks = []
    if n_breaks:
        bpos = np.sort(rng.integers(length // 10, length - length // 10,
                                    n_breaks))
        haps = rng.permutation(n_haps)[:n_breaks + 1]
        breaks = [(int(p), int(h)) for p, h in zip(bpos, haps[1:])]
    reads, target = sample_reads(rng, hap_seqs, coverage=coverage,
                                 read_len=read_len, error_rate=error_rate,
                                 recomb_breaks=breaks)
    write_gfa(graph, path=paths["gfa"])
    with gzip.open(paths["reads"], "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    with open(paths["truth"], "w") as f:
        f.write(">truth\n")
        for i in range(0, len(target), 80):
            f.write(target[i:i + 80] + "\n")
    with open(paths["meta"], "w") as f:
        json.dump({"n_haps": n_haps, "length": length, "coverage": coverage,
                   "seed": seed, "breaks": breaks, "n_reads": len(reads)},
                  f)
    return paths


def peak_rss_gb() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def run_one(n_haps: int, length: int = 5_000_000, coverage: float = 2.0,
            seed: int = 0, opt: Options | None = None,
            target_runs: int = 5, device="cuda", **kw) -> dict:
    """Build/reuse the instance, run the full pipeline on `device`
    median-of-N (eval/stats.py discipline), score vs truth."""
    from phi_tpu_torch import pipeline
    from phi_tpu_torch.eval.stats import run_stats
    device = pipeline.resolve_device(device)
    paths = build_instance(n_haps, length, coverage, seed, **kw)
    opt = opt or Options()
    out = os.path.join(os.path.dirname(paths["gfa"]), "inferred.fa")
    res, st_t = run_stats(
        lambda: pipeline.run_pipeline(paths["gfa"], paths["reads"], out, opt,
                                      device=device),
        target_runs=target_runs)
    with open(paths["truth"]) as f:
        truth = "".join(l.strip() for l in f if not l.startswith(">"))
    es = edit_stats(res.sequence, truth)
    with open(paths["meta"]) as f:
        meta = json.load(f)
    return {"n_haps": n_haps, "length": length, "coverage": coverage,
            "wall_s": st_t["median_s"], "n_runs": st_t["n_runs"],
            "wall_iqr_s": st_t["iqr_s"], "wall_raw_s": st_t["raw_s"],
            "peak_rss_gb": round(peak_rss_gb(), 2),
            "edit_distance": es.edit_distance,
            "recombinations": res.recombination_count,
            "true_breaks": len(meta["breaks"]),
            "gap": round(max(0.0, res.decode.true_objective
                             - res.decode.dp_objective), 3),
            "timings": {k: round(v, 2) for k, v in res.timings.items()}}


def progressive_subsets(gfa_path: str, reads_path: str, truth_path: str,
                        counts: list[int], opt: Options | None = None,
                        out_csv: str | None = None,
                        target_runs: int = 5,
                        device="cuda") -> list[dict]:
    """The reference's increasing.csv axes done the reference's way: ONE
    graph, progressively larger panel subsets (chop_graph.sh:37-69 derives
    3/7/13/25/49-hap GBZs from the 49-hap graph via ignore-lists; here
    io.subset.subset_panel), the SAME read set and truth across all rows.
    Every run is `pipeline.run_pipeline` on `device`."""
    from phi_tpu_torch import pipeline
    from phi_tpu_torch.eval.stats import run_stats
    from phi_tpu_torch.io.gfa import read_gfa
    from phi_tpu_torch.io.subset import subset_panel
    device = pipeline.resolve_device(device)
    opt = opt or Options()
    g = read_gfa(gfa_path)
    with open(truth_path) as f:
        truth = "".join(l.strip() for l in f if not l.startswith(">"))
    rows = []
    for n in counts:
        if n > len(g.walks):
            raise ValueError(f"subset {n} > {len(g.walks)} walks in graph")
        sub_path = os.path.join(os.path.dirname(gfa_path), f"panel_{n}.gfa")
        if n == len(g.walks):
            sub_path = gfa_path
        elif not os.path.exists(sub_path):
            write_gfa(subset_panel(g, list(range(n))), path=sub_path)
        out = os.path.join(os.path.dirname(gfa_path), f"inferred_{n}.fa")
        res, st_t = run_stats(
            lambda: pipeline.run_pipeline(sub_path, reads_path, out, opt,
                                          device=device),
            target_runs=target_runs)
        es = edit_stats(res.sequence, truth)
        rows.append({"n_haps": n, "wall_s": st_t["median_s"],
                     "n_runs": st_t["n_runs"], "wall_iqr_s": st_t["iqr_s"],
                     "wall_raw_s": st_t["raw_s"],
                     "peak_rss_gb": round(peak_rss_gb(), 2),
                     "edit_distance": es.edit_distance,
                     "recombinations": res.recombination_count,
                     "gap": round(max(0.0, res.decode.true_objective
                                      - res.decode.dp_objective), 3),
                     "timings": {k: round(v, 2)
                                 for k, v in res.timings.items()}})
    if out_csv:
        import csv
        with open(out_csv, "w", newline="") as f:
            wtr = csv.writer(f)
            wtr.writerow(["n_haps", "n_runs", "wall_median_s", "wall_iqr_s",
                          "wall_min_s", "wall_max_s", "peak_rss_gb",
                          "edit_distance", "recombinations", "gap",
                          "raw_times_s"])
            for r in rows:
                raw = r["wall_raw_s"]
                wtr.writerow([r["n_haps"], r["n_runs"], r["wall_s"],
                              r["wall_iqr_s"], min(raw), max(raw),
                              r["peak_rss_gb"], r["edit_distance"],
                              r["recombinations"], r["gap"],
                              " ".join(map(str, raw))])
    return rows


def mosaic_target(rng: np.random.Generator, hap_seqs: list[str],
                  length: int, n_breaks: int, private_rate: float) -> str:
    """A held-out target: a mosaic of the haplotypes with n_breaks
    switchpoints (drawn in the middle 80% of the shortest) in a random
    order of haplotypes, carrying private SNPs at private_rate."""
    n_haps = len(hap_seqs)
    bpos = np.sort(rng.integers(length // 10,
                                min(len(s) for s in hap_seqs) - length // 10,
                                n_breaks))
    hs = rng.permutation(n_haps)
    parts, cur, cursor = [], int(hs[0]), 0
    for i, p in enumerate(bpos.tolist()):
        parts.append(hap_seqs[cur][cursor:p])
        cur, cursor = int(hs[(i + 1) % n_haps]), p
    parts.append(hap_seqs[cur][cursor:])
    tgt = np.frombuffer("".join(parts).encode(), np.uint8).copy()
    priv = rng.random(len(tgt)) < private_rate
    tgt[priv] = np.frombuffer(b"ACGT", np.uint8)[
        (np.searchsorted(np.frombuffer(b"ACGT", np.uint8), tgt[priv])
         + rng.integers(1, 4, int(priv.sum()))) % 4]
    return tgt.tobytes().decode()


def build_heldout_instance(n_haps: int, length: int, coverages: list[float],
                           seed: int = 0, var_rate: float = 0.01,
                           error_rate: float = 0.003, n_rate: float = 0.002,
                           indel_fraction: float = 0.05,
                           private_rate: float = 5e-4,
                           n_breaks: int = 3) -> dict:
    """Leave-target-out panel (BASELINE config 3, the reference's headline
    low-coverage accuracy experiment, data/run_batch_1.py): the target is a
    recombinant mosaic of panel haplotypes (n_breaks switchpoints, like a
    real sample sharing segments with panel lineages) carrying private SNPs
    at private_rate — it is NOT a panel walk, so the inferred haplotype must
    recombine panel walks and its edit-distance floor is the private
    variation. Reads are sampled with sequencing errors and N positions at
    each coverage."""
    d = os.path.join(CACHE_DIR,
                     f"heldout_h{n_haps}_L{length}_s{seed}_v{var_rate:g}"
                     f"_e{error_rate:g}_n{n_rate:g}_p{private_rate:g}"
                     f"_b{n_breaks}")
    os.makedirs(d, exist_ok=True)
    gfa_path = os.path.join(d, "panel.gfa")
    truth_path = os.path.join(d, "truth.fa")
    read_paths = {c: os.path.join(d, f"reads_{c:g}x.fq.gz") for c in coverages}
    if not (os.path.exists(gfa_path) and os.path.exists(truth_path)
            and all(os.path.exists(p) for p in read_paths.values())):
        rng = np.random.default_rng(seed)
        graph, hap_seqs = synth_pangenome(rng, length=length, n_haps=n_haps,
                                          var_rate=var_rate,
                                          indel_fraction=indel_fraction)
        target = mosaic_target(rng, hap_seqs, length, n_breaks,
                               private_rate)
        write_gfa(graph, path=gfa_path)
        with open(truth_path, "w") as f:
            f.write(">target\n")
            for i in range(0, len(target), 80):
                f.write(target[i:i + 80] + "\n")
        for c in coverages:
            reads, _ = sample_reads(rng, [target], coverage=c,
                                    error_rate=error_rate)
            with gzip.open(read_paths[c], "wt") as f:
                for i, r in enumerate(reads):
                    arr = np.frombuffer(r.encode(), np.uint8).copy()
                    ns = rng.random(len(arr)) < n_rate
                    arr[ns] = ord("N")
                    rr = arr.tobytes().decode()
                    f.write(f"@r{i}\n{rr}\n+\n{'I' * len(rr)}\n")
    return {"gfa": gfa_path, "truth": truth_path, "reads": read_paths}


def heldout_sweep(n_haps: int = 8, length: int = 500_000,
                  coverages: list[float] | None = None, seed: int = 0,
                  out_csv: str | None = None, opt: Options | None = None,
                  with_baseline: bool = False, target_runs: int = 5,
                  device="cuda"):
    """Coverage sweep over the held-out-target panel on `device`; emits the
    data/plots-shaped CSV (cells '(time, rss, edit)'). with_baseline adds a
    best-single-panel-haplotype comparison row (the VG/PanGenie stand-in —
    eval/baselines.py)."""
    from phi_tpu_torch.eval.batch import (MatrixCell, run_matrix,
                                          write_matrix_csv)
    from phi_tpu_torch.pipeline import resolve_device
    device = resolve_device(device)
    coverages = coverages or [0.1, 0.5, 1.0, 2.0, 5.0, 10.0]
    inst = build_heldout_instance(n_haps, length, coverages, seed)
    cells = [("heldout", f"{c:g}x", inst["reads"][c], inst["truth"])
             for c in coverages]
    res = run_matrix(inst["gfa"], cells, opt or Options(), None,
                     target_runs=target_runs, device=device)
    if with_baseline:
        from phi_tpu_torch.eval.baselines import run_best_hap_baseline
        o = opt or Options()
        for c in coverages:
            b = run_best_hap_baseline(inst["gfa"], inst["reads"][c],
                                      inst["truth"], o.k, o.w, device)
            res.append(MatrixCell(
                read_name="besthap", coverage=f"{c:g}x",
                real_time_s=b["time_s"], peak_rss_gb=0.0,
                edit_distance=b["edit_distance"], recombinations=0))
    if out_csv:
        write_matrix_csv(res, out_csv)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="phi-torch-scale")
    ap.add_argument("--haps", default="49", help="comma list, e.g. 3,7,13,25,49")
    ap.add_argument("--length", type=int, default=5_000_000)
    ap.add_argument("--coverage", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-csv", default=None)
    ap.add_argument("--lagrangian", type=int, default=8)
    ap.add_argument("--runs", type=int, default=5,
                    help="repeat each measurement up to N times and report "
                         "median/IQR (cheap runs only; see eval/stats.py)")
    ap.add_argument("--heldout", action="store_true",
                    help="leave-target-out coverage sweep instead of the "
                         "hap-count scaling run")
    ap.add_argument("--subsets", action="store_true",
                    help="derive the smaller panels as subsets of the "
                         "largest graph (chop_graph.sh style: one graph, "
                         "one read set, progressive panels)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="torch device of the pipeline runs [cuda]")
    args = ap.parse_args(argv)
    try:
        return _main(args)
    except (ValueError, OSError, RuntimeError) as e:
        # a missing CUDA device and failed runs end as [E::main], exit 1
        sys.stderr.write(f"[E::main] {e}\n")
        return 1


def _main(args) -> int:
    from phi_tpu_torch.pipeline import resolve_device
    device = resolve_device(args.device)
    if args.heldout:
        n = int(args.haps.split(",")[0])
        res = heldout_sweep(n, args.length, seed=args.seed,
                            out_csv=args.out_csv,
                            opt=Options(lagrangian_rounds=args.lagrangian),
                            target_runs=args.runs, device=device)
        for c in res:
            print(json.dumps(dataclasses.asdict(c)), flush=True)
        return 0
    counts = [int(x) for x in args.haps.split(",")]
    if args.subsets:
        paths = build_instance(max(counts), args.length, args.coverage,
                               args.seed)
        rows = progressive_subsets(
            paths["gfa"], paths["reads"], paths["truth"], counts,
            opt=Options(lagrangian_rounds=args.lagrangian),
            out_csv=args.out_csv, target_runs=args.runs, device=device)
        for r in rows:
            print(json.dumps(r), flush=True)
        return 0
    rows = []
    for n in counts:
        r = run_one(n, args.length, args.coverage, args.seed,
                    opt=Options(lagrangian_rounds=args.lagrangian),
                    target_runs=args.runs, device=device)
        print(json.dumps(r), flush=True)
        rows.append(r)
    if args.out_csv:
        import csv
        with open(args.out_csv, "w", newline="") as f:
            wtr = csv.writer(f)
            wtr.writerow(["n_haps", "n_runs", "wall_median_s", "wall_iqr_s",
                          "peak_rss_gb", "edit_distance", "recombinations",
                          "true_breaks", "gap", "raw_times_s"])
            for r in rows:
                wtr.writerow([r["n_haps"], r["n_runs"], r["wall_s"],
                              r["wall_iqr_s"], r["peak_rss_gb"],
                              r["edit_distance"], r["recombinations"],
                              r["true_breaks"], r["gap"],
                              " ".join(map(str, r["wall_raw_s"]))])
    return 0


if __name__ == "__main__":
    sys.exit(main())
