"""Real-data imputation of the de-novo ground-truth MHC haplotypes (the
port's copy of `phi_tpu/eval/groundtruth.py`: every inference runs the
port's `run_pipeline` on `device`).

The reference's headline accuracy experiment (data/run_batch_1.py:41-52)
infers each of the 8 de-novo-assembled MHC haplotypes (Houwaart et al. 2022,
data/Ground_truth/{APD,COX,DBB,KAS116,MANN,PGF,QBL,SSTO}.fasta.gz) from
low-coverage reads against a real pangenome panel and scores edit distance
vs the truth (edlib-aligner). The published runs use the 49-hap
Minigraph-Cactus panel + real SRA read sets, both built by
data/preprocess.py:33-109 from network downloads — irreproducible offline.

This harness runs the same experiment against the real panel
(test/MHC_4.gfa.gz: CHM13.0, HG002.1/2, HG005.1/2 — none of the 8 targets
is in the panel, so every cell is genuine held-out imputation) with reads
simulated from the real truth assemblies at the reference's coverage
ladder {0.1, 0.5, 1, 2, 5, 10}x (data/preprocess.py:85-109), read length
150, substitution error rate 0.3%. Each cell reports the inferred mosaic's
edit distance (median over seeds), the best-single-panel-hap floor (the
edit distance a non-recombining imputer could at best reach — the
reference's get_edit_stats.sh computes exactly this truth-vs-panel table),
the recombination count, and the solver's certification gap.

The reference checkout is PHI_REFERENCE_DIR (default `reference` in the
working directory). The truth directory is resolved when called:
`load_truth` and `run_grid` take `truth_dir=None` for GROUND_TRUTH_DIR,
so a run can read other truths (synthetic stand-ins on a machine without
the assemblies).

    python -m phi_tpu_torch.eval.groundtruth --out bench_results/groundtruth \
        [--coverages 0.1,0.5,1,2,5,10] [--seeds 3] [--samples APD,COX,...] \
        [--device cuda]
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import tempfile
import time

import numpy as np

# a checkout of the reference (at-cg/PHI), which holds the truths and the
# panel; PHI_REFERENCE_DIR names it
REFERENCE_DIR = os.environ.get("PHI_REFERENCE_DIR", "reference")
GROUND_TRUTH_DIR = os.path.join(REFERENCE_DIR, "data", "Ground_truth")
PANEL_GFA = os.path.join(REFERENCE_DIR, "test", "MHC_4.gfa.gz")
SAMPLES = ("APD", "COX", "DBB", "KAS116", "MANN", "PGF", "QBL", "SSTO")
COVERAGES = (0.1, 0.5, 1.0, 2.0, 5.0, 10.0)


def load_truth(sample: str, truth_dir: str | None = None) -> str:
    path = os.path.join(truth_dir or GROUND_TRUTH_DIR, f"{sample}.fasta.gz")
    with gzip.open(path, "rt") as f:
        return "".join(l.strip() for l in f if not l.startswith(">")).upper()


def panel_floor(graph, truth: str) -> tuple[str, int]:
    """(best walk name, edit distance) over the panel — the imputation
    floor of any single-haplotype (non-recombining) method."""
    from phi_tpu_torch.eval.edits import edit_stats
    best_name, best_ed = "", -1
    for h in range(graph.num_walks):
        seq = graph.path_seq(graph.walk_mat[h, :graph.walk_len[h]])
        ed = edit_stats(truth, seq).edit_distance
        if best_ed < 0 or ed < best_ed:
            best_name, best_ed = graph.walk_names[h], ed
    return best_name, best_ed


def panel_floor_cached(graph, truth: str, sample: str, gfa_path: str,
                       cache_path: str = "bench_results/.floors_cache.json"
                       ) -> tuple[str, int]:
    """panel_floor with a small on-disk cache: the floor depends only on
    (panel, truth) and the banded-Myers pass costs minutes per sample at
    MHC scale — identical across error-model grids and parallel shards."""
    import zlib
    key = f"{os.path.basename(gfa_path)}:{sample}:" \
          f"{zlib.crc32(truth.encode())}"
    try:
        with open(cache_path) as f:
            cache = json.load(f)
    except Exception:
        cache = {}
    if key in cache:
        return cache[key][0], int(cache[key][1])
    name, ed = panel_floor(graph, truth)
    cache[key] = [name, ed]
    try:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        tmp = cache_path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(cache, f)
        os.replace(tmp, cache_path)
    except Exception:
        pass
    return name, ed


# Reference-shaped read error profiles: the published accuracy runs use
# real SRA reads (indel errors included, data/preprocess.py:64-109);
# "subs" reproduces the substitution-only grid, "indel" adds the
# short-read indel class, "longread" is an ONT/PacBio-CLR-like profile.
ERROR_MODELS = {
    "subs": {"error_rate": 0.003, "indel_rate": 0.0, "read_len": 150},
    "indel": {"error_rate": 0.003, "indel_rate": 0.001, "read_len": 150},
    "longread": {"error_rate": 0.01, "indel_rate": 0.01, "read_len": 10000},
}

# certification escalation for stuck cells: a cell whose gap stays above
# the tolerance under the default dual-ascent/B&B budgets is re-solved
# once with these (read by the pipeline when it runs)
_ESCALATION_ENV = {"PHI_TPU_SUBGRAD_ITERS": "200",
                   "PHI_TPU_BNB_NODES": "500",
                   "PHI_TPU_BNB_SECS": "900"}


def infer_cell(gfa_path: str, truth: str, coverage: float, seed: int,
               error_rate: float = 0.003, read_len: int = 150,
               opt=None, indel_rate: float = 0.0,
               escalate_tol: float | None = None, device="cuda") -> dict:
    """One (sample, coverage, seed) inference run against the panel on
    `device`. escalate_tol: when set and the certification gap exceeds it,
    the solve reruns once under the escalated dual-ascent/B&B budgets;
    os.environ is restored afterwards, on an exception too."""
    import dataclasses

    from phi_tpu_torch import pipeline
    from phi_tpu_torch.config import Options
    from phi_tpu_torch.eval.edits import edit_stats
    from phi_tpu_torch.eval.synth import sample_reads

    device = pipeline.resolve_device(device)
    rng = np.random.default_rng(seed)
    reads, _ = sample_reads(rng, [truth], coverage=coverage,
                            read_len=read_len, error_rate=error_rate,
                            indel_rate=indel_rate)
    with tempfile.TemporaryDirectory() as d:
        reads_path = os.path.join(d, "reads.fa")
        with open(reads_path, "w") as f:
            for i, r in enumerate(reads):
                f.write(f">r{i}\n{r}\n")
        out = os.path.join(d, "out.fa")
        t0 = time.time()
        res = pipeline.run_pipeline(gfa_path, reads_path, out,
                                    opt or Options(), device=device)
        gap = max(0.0, res.decode.true_objective - res.decode.dp_objective)
        escalated = False
        if escalate_tol is not None and gap > escalate_tol:
            escalated = True
            saved = {k: os.environ.get(k) for k in _ESCALATION_ENV}
            os.environ.update(_ESCALATION_ENV)
            try:
                opt2 = dataclasses.replace(opt or Options(),
                                           lagrangian_rounds=16)
                res = pipeline.run_pipeline(gfa_path, reads_path, out, opt2,
                                            device=device)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            gap = max(0.0, res.decode.true_objective
                      - res.decode.dp_objective)
        wall = time.time() - t0
        ed = edit_stats(res.sequence, truth).edit_distance
    return {"edit": ed, "recombinations": res.recombination_count,
            "gap": round(gap, 3), "wall_s": round(wall, 2),
            "n_reads": len(reads), "escalated": escalated}


def run_grid(samples=SAMPLES, coverages=COVERAGES, seeds: int = 3,
             gfa_path: str = PANEL_GFA, error_model: str = "subs",
             progress=True, escalate: bool = True, device="cuda",
             truth_dir: str | None = None) -> dict:
    """The (sample x coverage x seed) grid on `device`, truths read from
    `truth_dir` (GROUND_TRUTH_DIR when None)."""
    from phi_tpu_torch.graph.pangenome import tensorize
    from phi_tpu_torch.io.gfa import read_gfa
    from phi_tpu_torch.pipeline import gap_tol, resolve_device

    device = resolve_device(device)
    em = ERROR_MODELS[error_model]
    graph = tensorize(read_gfa(gfa_path))
    tol = gap_tol(100.0)
    rows = []
    floors = {}
    for sample in samples:
        truth = load_truth(sample, truth_dir)
        t0 = time.time()
        floor_name, floor_ed = panel_floor_cached(graph, truth, sample, gfa_path)
        floors[sample] = {"best_hap": floor_name, "edit": floor_ed,
                          "truth_len": len(truth)}
        if progress:
            print(f"[gt] {sample}: floor {floor_ed} ({floor_name}) "
                  f"[{time.time() - t0:.0f}s]", file=sys.stderr, flush=True)
        for cov in coverages:
            edits, cells = [], []
            for s in range(seeds):
                cell = infer_cell(
                    gfa_path, truth, cov, seed=1000 * s + 7,
                    error_rate=em["error_rate"], read_len=em["read_len"],
                    indel_rate=em["indel_rate"],
                    escalate_tol=tol if escalate else None, device=device)
                edits.append(cell["edit"])
                cells.append(cell)
            med = int(np.median(edits))
            certified = all(c["gap"] <= tol for c in cells)
            rows.append({
                "sample": sample, "coverage": cov,
                "edit_median": med, "edit_raw": edits,
                "floor_edit": floor_ed,
                "beats_floor": bool(med < floor_ed),
                "recombinations": [c["recombinations"] for c in cells],
                "gaps": [c["gap"] for c in cells],
                "escalated": [c["escalated"] for c in cells],
                "certified": certified,
                "wall_s": [c["wall_s"] for c in cells],
            })
            if progress:
                print(f"[gt] {sample} {cov}x: edit {med} (raw {edits}) "
                      f"floor {floor_ed} certified={certified} "
                      f"gaps={[c['gap'] for c in cells]}",
                      file=sys.stderr, flush=True)
    return {
        "data": "real",
        "note": "real panel (test/MHC_4.gfa.gz) + real de-novo truth "
                "assemblies (data/Ground_truth); reads SIMULATED from the "
                f"truth under the '{error_model}' error model at the "
                "reference's coverage ladder — the published SRA read sets "
                "and the 49-hap panel need network access "
                "(data/preprocess.py) and are irreproducible offline",
        "panel": PANEL_GFA,
        "panel_walks": list(graph.walk_names),
        "coverage_ladder_source": "data/preprocess.py:85-109",
        "experiment_source": "data/run_batch_1.py:41-52",
        "seeds": seeds, "error_model": error_model,
        "error_rate": em["error_rate"], "indel_rate": em["indel_rate"],
        "read_len": em["read_len"],
        "floors": floors, "cells": rows,
    }


def write_outputs(result: dict, out_prefix: str) -> None:
    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    with open(out_prefix + ".json", "w") as f:
        json.dump(result, f, indent=1)
    covs = sorted({r["coverage"] for r in result["cells"]})
    lines = ["| sample | floor | " + " | ".join(f"{c}x" for c in covs)
             + " |", "|---|---|" + "---|" * len(covs)]
    by = {(r["sample"], r["coverage"]): r for r in result["cells"]}
    samples = list(dict.fromkeys(r["sample"] for r in result["cells"]))
    for s in samples:
        cells = []
        for c in covs:
            r = by.get((s, c))
            mark = "" if r is None or r["certified"] else "*"
            cells.append(f"{r['edit_median']}{mark}" if r else "-")
        lines.append(f"| {s} | {result['floors'][s]['edit']} | "
                     + " | ".join(cells) + " |")
    lines.append("")
    n_beat = sum(1 for r in result["cells"] if r["beats_floor"])
    lines.append(f"Mosaic beats the best-single-hap floor in {n_beat}/"
                 f"{len(result['cells'])} cells; '*' marks uncertified "
                 f"cells (gap > tolerance on >= 1 seed).")
    lines.append("")
    lines.append(result["note"])
    with open(out_prefix + ".md", "w") as f:
        f.write("# Ground-truth imputation grid (real data)\n\n"
                + "\n".join(lines) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="phi-torch-groundtruth")
    ap.add_argument("--out", default="bench_results/groundtruth")
    ap.add_argument("--samples", default=",".join(SAMPLES))
    ap.add_argument("--coverages",
                    default=",".join(str(c) for c in COVERAGES))
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--gfa", default=PANEL_GFA)
    ap.add_argument("--error-model", default="subs",
                    choices=sorted(ERROR_MODELS))
    ap.add_argument("--no-escalate", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="torch device of the pipeline runs [cuda]")
    args = ap.parse_args(argv)
    try:
        res = run_grid(samples=args.samples.split(","),
                       coverages=[float(c) for c in args.coverages.split(",")],
                       seeds=args.seeds, gfa_path=args.gfa,
                       error_model=args.error_model,
                       escalate=not args.no_escalate, device=args.device)
    except (ValueError, OSError, RuntimeError) as e:
        # a missing CUDA device, panel or truth ends as [E::main], exit 1
        sys.stderr.write(f"[E::main] {e}\n")
        return 1
    write_outputs(res, args.out)
    print(json.dumps({"cells": len(res["cells"]),
                      "beats_floor": sum(1 for r in res["cells"]
                                         if r["beats_floor"]),
                      "all_certified": all(r["certified"]
                                           for r in res["cells"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
