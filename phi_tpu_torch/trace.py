"""Where the device time goes in one warm run of the pipeline on the card.

    python -m phi_tpu_torch.trace [-k 35]

Builds (or reuses) the synthetic instance of the reference's configuration
(49 haplotypes x 5 Mbp, 1x reads, `-k 31 -w 25 -R 100`; `-k` sets another
k, such as 35 for the wide rows3w route), runs the pipeline on cuda once
cold and once warm, then once more under torch.profiler, and prints one
JSON object:
  - `wall_s`: the warm run's `timings["total"]`, unprofiled, and
    `timings`: that run's whole `timings` (the host phases);
  - `profiled_wall_s`: the same for the profiled run;
  - `busy_s`: the length of the union of the intervals of every kernel,
    copy and fill that ran on the card in the profiled run, so events that
    overlap count once;
  - `busy_share`: busy_s / wall_s, and `busy_share_profiled`:
    busy_s / profiled_wall_s (the profiler slows the host, not the card);
  - `by_name`: device milliseconds and event counts of the 25 largest
    event names (summed, not merged; names cut to 120 characters).
Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

# the reference's published configuration (BASELINE.md)
HAPS, LENGTH, COVERAGE = 49, 5_000_000, 1.0


def merged_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is not None and s <= cur_e:
            cur_e = max(cur_e, e)
            continue
        if cur_e is not None:
            total += cur_e - cur_s
        cur_s, cur_e = s, e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_events(prof) -> list[tuple[str, float, float]]:
    """(name, start_us, end_us) of the profiled events that ran on the card
    (kernels, copies, fills); annotation ranges are left out."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def summarize(events, wall_s: float, profiled_wall_s: float) -> dict:
    busy_s = merged_us((s, e) for _, s, e in events) / 1e6
    by_name: dict[str, list] = {}
    for name, s, e in events:
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += (e - s) / 1e3
        acc[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"wall_s": wall_s, "profiled_wall_s": profiled_wall_s,
            "busy_s": busy_s, "busy_share": busy_s / wall_s,
            "busy_share_profiled": busy_s / profiled_wall_s,
            "n_events": len(events),
            "by_name": [{"name": n, "ms": ms, "count": c}
                        for n, (ms, c) in top]}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m phi_tpu_torch.trace")
    p.add_argument("-k", type=int, default=31, help="k-mer size [31]")
    k = p.parse_args(argv).k
    if not torch.cuda.is_available():
        print("[trace] no CUDA device", file=sys.stderr)
        return 1
    # instances are cached inside the checkout, beside the kernel build
    os.environ.setdefault("PHI_TPU_SCALE_CACHE", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "_build", "scale"))
    from phi_tpu_torch import cli
    from phi_tpu_torch.eval import build_instance
    from phi_tpu_torch.pipeline import run_pipeline
    paths = build_instance(HAPS, LENGTH, coverage=COVERAGE)
    out = os.path.join(os.path.dirname(paths["gfa"]), "trace.fa")
    opt = cli.options_from_args(cli.build_parser().parse_args(
        ["-g", paths["gfa"], "-r", paths["reads"], "-o", out,
         "-k", str(k), "-w", "25", "-R", "100"]))
    dev = torch.device("cuda")

    def run():
        r = run_pipeline(paths["gfa"], paths["reads"], out, opt, device=dev)
        torch.cuda.synchronize()
        return r.timings

    run()                                     # cold: build, CUDA context
    timings = run()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = run()["total"]
    res = summarize(device_events(prof), timings["total"], profiled)
    res["timings"] = timings
    res["by_name"] = [dict(d, name=d["name"][:120])
                      for d in res["by_name"][:25]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    res["card"] = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    res["instance"] = {"haps": HAPS, "length": LENGTH, "coverage": COVERAGE,
                       "k": k}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
