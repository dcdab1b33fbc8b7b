"""A tiny copy of the benchmark for the CPU tests: the real drivers,
metrics and traffic, BENCHMARK.json's cells and those of
left_out_cells.json pointed at one small panel."""

from __future__ import annotations

import json
import os
import shutil
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def make_root(path: str, length: int = 30000, haps: int = 6) -> str:
    os.makedirs(os.path.join(path, "phibench", "configs"))
    for d in ("drivers", "metrics", "traffic"):
        shutil.copytree(os.path.join(BENCH, d),
                        os.path.join(path, "phibench", d))
    with open(os.path.join(BENCH, "configs", "mhc49.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny"
    cfg["panel"].update(length=length, haplotypes=haps)
    with open(os.path.join(path, "phibench", "configs", "tiny.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    merge_left_out(man)
    for w in man["workloads"]:
        w["config"] = "tiny"
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return path


def merge_left_out(man: dict) -> None:
    """Adds left_out_cells.json's cells to a manifest: its entries named
    like a metric there extend that metric's cells, the others are added
    whole."""
    with open(os.path.join(BENCH, "tests", "left_out_cells.json")) as f:
        left = json.load(f)
    man["workloads"] += left["workloads"]
    for key in ("end_to_end", "per_layer"):
        have = {m["name"]: m for m in man[key]}
        for m in left[key]:
            if m["name"] in have:
                have[m["name"]]["workloads"] += m["workloads"]
            else:
                man[key].append(m)


def run_cell(root: str, cell: str, seed: int = 2**31 + 5, seconds=1.0,
             trace=False, control=False):
    from phibench import harness
    t0 = time.monotonic()
    run = harness.Run(cell, seed, seconds, trace, device="cpu", root=root,
                      control=control,
                      cache_root=os.path.join(root, "cache"))
    return run, harness.execute(run, lambda: time.monotonic() - t0)
