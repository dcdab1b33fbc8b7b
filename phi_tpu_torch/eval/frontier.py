"""Optimality failure-frontier mapper: the port's counterpart of
`phi_tpu/eval/frontier.py`.

The reference's Gurobi solve is exact for every instance; the DP +
Lagrangian replacement is certified only when its duality gap closes. This
module sweeps adversarial instance families against the brute-force
expanded-graph oracle (solve/exact.py), recording per instance whether the
gap certified and the emitted path's excess over the true optimum.

Families (each parameterized, all sized to stay brute-forceable):
  paralog   duplicate-credit traps: lane B repeats a read motif at `mult`
            distinct loci, so the raw relaxation bound scales like -mult
            while the optimum stays near 0.
  lowR      random recombination instances at R in {0.1, 0.25, 0.5}.
  threshold T < 1 keeps k-mers that occur in fewer haplotypes.
  zerolen   chains of empty (zero-length) nodes, VCF deletion chains, push
            k-mer spans past MAX_LAYERS, so the solver takes the bracket
            solve (n_layers None).

Each case runs the port's `_solve_with_refinement` on `device`; the read
spectrum comes from the native scan (`pipeline.read_spectrum`) and the
walks are sketched by `anchors.join.sketch_haplotypes`.

    python -m phi_tpu_torch.eval.frontier --seeds 50 --out-csv frontier.csv
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import random
import sys

import numpy as np

from phi_tpu_torch.anchors.join import build_anchor_tables, sketch_haplotypes
from phi_tpu_torch.config import Options
from phi_tpu_torch.graph.pangenome import tensorize
from phi_tpu_torch.io.build import build_gfa_data
from phi_tpu_torch.io.gfa import encode_seq
from phi_tpu_torch.io.reads import ReadBatch
from phi_tpu_torch.pipeline import (_solve_with_refinement, gap_tol,
                                    read_spectrum, resolve_device)
from phi_tpu_torch.solve.exact import brute_force_optimum
from phi_tpu_torch.solve.prep import build_solver_tables, solver_layers


@dataclasses.dataclass
class FrontierCase:
    family: str
    seed: int
    params: str
    exact: float            # brute-force optimum
    emitted: float          # true objective of the emitted path
    bound: float            # final certified lower bound
    gap: float              # emitted - bound
    excess: float           # emitted - exact (the quality loss, if any)
    certified: bool
    n_states: int
    bracket_mode: bool      # the solver took the bracket solve


def _solve_case(graph, read: str, k: int, w: int, R: float, T: float,
                device, rounds: int = 8) -> tuple:
    reads = ReadBatch(np.array([len(read)], np.int32), ["read"],
                      concat=encode_seq(read),
                      off=np.array([0, len(read)], np.int64))
    spectrum = read_spectrum(reads, k, w)
    sketches = sketch_haplotypes(graph, k, w, device=device)
    anchors = build_anchor_tables(graph, k, sketches, spectrum, T)
    opt = Options(k=k, w=w, recombination=R, threshold=T,
                  lagrangian_rounds=rounds)
    res = _solve_with_refinement(graph, anchors, opt, device)
    tables = build_solver_tables(graph, anchors, R, solver_layers(graph, k))
    exact, _ = brute_force_optimum(graph, tables, anchors)
    H, P = tables.state_vertex.shape
    return res, exact, H * P, tables.n_layers is None


def _case_record(family: str, seed: int, params: str, res, exact: float,
                 n_states: int, bracket: bool, R: float) -> FrontierCase:
    gap = max(0.0, res.true_objective - res.dp_objective)
    return FrontierCase(
        family=family, seed=seed, params=params, exact=round(exact, 3),
        emitted=round(res.true_objective, 3),
        bound=round(res.dp_objective, 3), gap=round(gap, 3),
        excess=round(res.true_objective - exact, 3),
        certified=gap <= gap_tol(R) + 1e-6, n_states=n_states,
        bracket_mode=bracket)


# ---------------------------------------------------------------- families

def _random_blocks(rng: random.Random, n_blocks: int, n_haps: int,
                   switch_p: float = 0.35):
    """Anchored variant-site graph + recombinant read."""
    bases = "ACGT"
    segments: dict[str, str] = {}
    walks_segs: list[list[str]] = [[] for _ in range(n_haps)]
    for b in range(n_blocks):
        anchor = "".join(rng.choice(bases) for _ in range(rng.randint(4, 7)))
        segments[f"a{b}"] = anchor
        for h in range(n_haps):
            walks_segs[h].append(f"a{b}")
        if b < n_blocks - 1:
            alleles = []
            for a in range(rng.randint(1, 3)):
                name = f"v{b}_{a}"
                segments[name] = "".join(
                    rng.choice(bases) for _ in range(rng.randint(2, 6)))
                alleles.append(name)
            for h in range(n_haps):
                walks_segs[h].append(alleles[rng.randrange(len(alleles))])
    g = tensorize(build_gfa_data(
        segments, [(f"hap{h}.0", walks_segs[h]) for h in range(n_haps)]))
    h = rng.randrange(n_haps)
    read = ""
    for b in range(len(walks_segs[h])):
        if rng.random() < switch_p:
            h = rng.randrange(n_haps)
        read += segments[walks_segs[h][b]]
    return g, read


def case_paralog(seed: int, mult: int, device="cuda") -> FrontierCase:
    rng = random.Random(seed)
    bases = "ACGT"
    motif = "ACGGTTCAAGGC"
    segments: dict[str, str] = {}
    A: list[str] = []
    B: list[str] = []
    sid = 0

    def seg(seq: str) -> list[str]:
        nonlocal sid
        out = []
        for i in range(0, len(seq), 5):
            name = f"s{sid}"
            sid += 1
            segments[name] = seq[i:i + 5]
            out.append(name)
        return out

    shared0 = seg("TTACCGGATCAA")
    A += shared0
    B += shared0
    for _ in range(mult):
        A += seg("".join(rng.choice(bases) for _ in range(12)))
        B += seg(motif + rng.choice(bases))
    sharedN = seg("GGTTACAGCATT")
    A += sharedN
    B += sharedN
    graph = tensorize(build_gfa_data(segments, [("A.0", A), ("B.0", B)]))
    read = "".join(segments[s] for s in A) + motif
    res, exact, n_states, br = _solve_case(graph, read, 8, 3, 100.0, 1.0,
                                           device, rounds=12)
    return _case_record("paralog", seed, f"mult={mult}", res, exact,
                        n_states, br, 100.0)


def case_lowR(seed: int, R: float, device="cuda") -> FrontierCase:
    rng = random.Random(seed)
    graph, read = _random_blocks(rng, rng.randint(3, 6), rng.randint(2, 4),
                                 switch_p=0.5)
    k, w = rng.choice([3, 4, 5]), rng.choice([1, 2])
    res, exact, n_states, br = _solve_case(graph, read, k, w, R, 1.0, device)
    return _case_record("lowR", seed, f"R={R} k={k} w={w}", res, exact,
                        n_states, br, R)


def case_threshold(seed: int, T: float, device="cuda") -> FrontierCase:
    rng = random.Random(seed)
    graph, read = _random_blocks(rng, rng.randint(3, 6), rng.randint(3, 4))
    k, w = rng.choice([4, 5]), rng.choice([1, 2])
    R = rng.choice([0.5, 1.0, 5.0])
    res, exact, n_states, br = _solve_case(graph, read, k, w, R, T, device)
    return _case_record("threshold", seed, f"T={T} R={R} k={k} w={w}", res,
                        exact, n_states, br, R)


def case_zerolen(seed: int, chain: int, device="cuda") -> FrontierCase:
    """Two haplotypes disagree across a deletion chain: hap A walks `chain`
    empty nodes (a VCF deletion ladder), hap B carries the inserted bases.
    k-mers straddle the whole chain, spans exceed MAX_LAYERS, and the
    solver must take the bracket solve."""
    rng = random.Random(seed)
    bases = "ACGT"
    segments: dict[str, str] = {}
    A: list[str] = []
    B: list[str] = []
    left = "".join(rng.choice(bases) for _ in range(10))
    right = "".join(rng.choice(bases) for _ in range(10))
    segments["L"] = left
    segments["Rr"] = right
    A.append("L")
    B.append("L")
    ins = "".join(rng.choice(bases) for _ in range(6))
    for i in range(chain):
        segments[f"z{i}"] = ""          # zero-length deletion node
        A.append(f"z{i}")
    segments["ins"] = ins
    B.append("ins")
    A.append("Rr")
    B.append("Rr")
    graph = tensorize(build_gfa_data(segments, [("A.0", A), ("B.0", B)]))
    # the read matches hap A's sequence (the deletion allele)
    read = left + right
    res, exact, n_states, br = _solve_case(graph, read, 8, 2, 1.0, 1.0,
                                           device)
    return _case_record("zerolen", seed, f"chain={chain}", res, exact,
                        n_states, br, 1.0)


# ---------------------------------------------------------------- sweep

def sweep(n_seeds: int = 25, device="cuda") -> list[FrontierCase]:
    cases: list[FrontierCase] = []
    for s in range(n_seeds):
        for mult in (8, 32, 96):
            cases.append(case_paralog(1000 + s, mult, device))
        for R in (0.1, 0.25, 0.5):
            cases.append(case_lowR(2000 + s, R, device))
        for T in (0.5, 0.75, 0.9):
            cases.append(case_threshold(3000 + s, T, device))
        for chain in (16, 70, 120):
            cases.append(case_zerolen(4000 + s, chain, device))
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m phi_tpu_torch.eval.frontier")
    ap.add_argument("--seeds", type=int, default=25)
    ap.add_argument("--out-csv", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    cases = sweep(args.seeds, resolve_device(args.device))
    if args.out_csv:
        import csv
        with open(args.out_csv, "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow([f.name for f in dataclasses.fields(FrontierCase)])
            for c in cases:
                wr.writerow(dataclasses.astuple(c))
    worst = sorted(cases, key=lambda c: (-c.excess, -c.gap))[:10]
    summary = {
        "n_cases": len(cases),
        "n_uncertified": sum(not c.certified for c in cases),
        "n_with_excess": sum(c.excess > 1e-6 for c in cases),
        "max_excess": max((c.excess for c in cases), default=0.0),
        "max_gap": max((c.gap for c in cases), default=0.0),
        "worst": [dataclasses.asdict(c) for c in worst if c.gap > 0
                  or c.excess > 0],
    }
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
