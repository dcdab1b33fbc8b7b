"""The comparison that decides `correct`: each output of a checked
inference against the plain reference (reference.py), as numbers, each
with its limit.

  spectrum      |program's read spectrum size - reference's|
  minimizers    sum over walks of |minimizer count difference|
  anchors       sum over walks of |retained occurrence count difference|
  filtered      |k-mers dropped by the threshold filter, difference|
  model_kmers   |model k-mer count difference|
  bound         how far the program's bound lies outside [reference
                bound, reference objective of the program's path]: below
                the first it is weaker than the relaxation, above the second
                it is no bound
  objective     |program's path objective - the reference's objective of
                that same path|
  certificate   the reference's objective of the program's path minus the
                reference's bound: within the configuration's certification
                tolerance the path is optimal
  path          rules the program's path breaks (start, end, switches)
  fasta         bases of the FASTA on disk that differ from the path's
                sequence, plus the length difference, plus 1 for a header
                whose LN is not the length
  report        recombination report entries that differ, plus the
                difference of the recombination counts
Counts and the path's sequence are exact, so their limit is 0. The
limits of the bound and the objective lie between the program's readings
(0 on every seed tried) and the control's (the reference in bfloat16 in
the program's place: the smallest reading 1,004,053 for the bound, 141 for
the objective), 0.6 of the way to the control's; PERF.md gives the
readings. The certificate's limit is the configuration's `certify_tol`.
It judges the path against the reference's relaxed bound, which equals
the exact optimum where no path can meet a model k-mer twice, as on the
benchmark's panels (random backbones, paths that only move forward).
"""

from __future__ import annotations

import numpy as np
import torch

from phibench import reference as ref

LIMITS = {"spectrum": 0, "minimizers": 0, "anchors": 0, "filtered": 0,
          "model_kmers": 0, "bound": 600_000, "objective": 85, "path": 0,
          "fasta": 0, "report": 0}


def limits(config: dict) -> dict:
    return dict(LIMITS, certificate=config["certify_tol"])


def judge(out: dict, an: ref.Anchors, bound: float, pi: ref.PanelIndex,
          panel, dtype=torch.float64) -> dict:
    """The numbers of one program output `out` (drivers' `outputs`)
    against the reference's anchors `an` and bound at out["R"]."""
    segs = [tuple(map(int, s)) for s in out["segments"]]
    faults = ref.path_faults(pi, segs)
    vals = {
        "spectrum": abs(out["spectrum_size"] - an.spectrum_size),
        "minimizers": int(np.abs(np.asarray(out["minimizers"])
                                 - np.asarray(an.minimizers)).sum())
        if len(out["minimizers"]) == len(an.minimizers) else 10**9,
        "anchors": int(np.abs(np.asarray(out["anchors"])
                              - np.asarray(an.anchors)).sum())
        if len(out["anchors"]) == len(an.anchors) else 10**9,
        "filtered": abs(out["filtered"] - an.filtered),
        "model_kmers": abs(out["model_kmers"] - an.model_kmers),
        "path": faults,
    }
    if faults:
        obj = float("inf")
        vals["fasta"] = vals["report"] = 10**9
    else:
        obj = ref.path_objective(an, segs, out["R"], dtype)
        head, codes = ref.read_fasta(out["fasta"])
        seq = ref.path_sequence(panel, segs)
        n = min(len(seq), len(codes))
        vals["fasta"] = (int((seq[:n] != codes[:n]).sum())
                         + abs(len(seq) - len(codes))
                         + int(f" LN:{len(codes)}" not in head))
        count, rep = ref.path_report(panel, segs)
        prog = list(out["report"])
        vals["report"] = (abs(count - out["recombinations"])
                          + sum(a != b for a, b in zip(rep, prog))
                          + abs(len(rep) - len(prog)))
    b = out["bound"]
    vals["bound"] = max(bound - b, b - obj, 0.0)
    vals["objective"] = abs(out["objective"] - obj)
    vals["certificate"] = obj - bound
    return vals


def worst(rows: list[dict]) -> dict:
    """The largest reading of each number over the checked outputs."""
    out: dict = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def passes(values: dict, lim: dict) -> bool:
    return bool(values) and all(values.get(k, float("inf")) <= v
                                for k, v in lim.items())
