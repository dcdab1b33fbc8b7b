"""Merge per-sample ground-truth grid shards (eval.groundtruth run with
--samples X) into one artifact per error model; the port's copy of
`phi_tpu/eval/merge_gt.py` (host only).

    python -m phi_tpu_torch.eval.merge_gt --parts bench_results/gt_parts \
        --model subs --out bench_results/groundtruth
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def merge(parts_dir: str, model: str, out_prefix: str) -> dict | None:
    from phi_tpu_torch.eval.groundtruth import SAMPLES, write_outputs
    from phi_tpu_torch.pipeline import gap_tol
    merged = None
    for sample in SAMPLES:
        path = os.path.join(parts_dir, f"{model}_{sample}.json")
        if not os.path.exists(path):
            print(f"[merge-gt] missing shard {path}", file=sys.stderr)
            continue
        with open(path) as f:
            part = json.load(f)
        if merged is None:
            merged = part
        else:
            merged["cells"].extend(part["cells"])
            merged["floors"].update(part["floors"])
    if merged is None:
        return None
    # re-derive certification from the recorded numeric gaps under the
    # current tolerance: integer R makes objective values integer-spaced,
    # so gap < 1 (0.99 with float-noise margin) is a valid optimality
    # certificate (pipeline.gap_tol); older shards carry booleans computed
    # at a tolerance of 0.5
    tol = gap_tol(100.0)
    for r in merged["cells"]:
        r["certified"] = bool(all(g <= tol for g in r["gaps"]))
    merged["certification_tolerance"] = tol
    write_outputs(merged, out_prefix)
    return merged


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="phi-torch-merge-gt")
    ap.add_argument("--parts", default="bench_results/gt_parts")
    ap.add_argument("--model", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    m = merge(args.parts, args.model, args.out)
    if m is None:
        return 1
    print(json.dumps({"cells": len(m["cells"]),
                      "certified": sum(r["certified"] for r in m["cells"]),
                      "beats_floor": sum(r["beats_floor"]
                                         for r in m["cells"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
