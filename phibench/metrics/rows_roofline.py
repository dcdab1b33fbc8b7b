"""The join kernels' share of their roofline, in percent: the least time
the window's joins need over the profiler's device time of the kernels
named in rows_roofline.kernels.txt.

The least time is bytes over the card's published HBM bandwidth
(phibench/peaks.json). The bytes come from the cell's inputs alone,
whatever implements them, for each inference: every walk base once at 2
bits, the read spectrum's keys once (8 bytes a key), and each retained
occurrence written once (a 32-bit walk interval and a 32-bit k-mer id).
None without a traced card run or where the kernels ran no time."""

import json
import os

_HERE = os.path.dirname(os.path.abspath(__file__))


def join_bytes(walk_bases: int, spectrum_size: int, anchors: int) -> int:
    return walk_bases // 4 + 8 * spectrum_size + 8 * anchors


def kernel_names() -> list[str]:
    with open(os.path.join(_HERE, "rows_roofline.kernels.txt")) as f:
        return [ln.strip() for ln in f
                if ln.strip() and not ln.startswith("#")]


def read(run):
    if run.trace is None or not run.on_card:
        return None
    import torch
    with open(os.path.join(os.path.dirname(_HERE), "peaks.json")) as f:
        peak = json.load(f).get(torch.cuda.get_device_name(0))
    if peak is None:
        return None
    names = kernel_names()
    dev_us = sum(v for n, v in run.trace["ops"].items()
                 if any(k in n for k in names))
    if dev_us <= 0:
        return None
    total = sum(join_bytes(run.walk_bases, r["out"]["spectrum_size"],
                           sum(r["out"]["anchors"]))
                for r in run.records if r.get("out") is not None)
    return 100.0 * (total / peak["hbm_bytes_per_s"]) / (dev_us / 1e6)
