"""The port's tracing: the span recorder behind `run_pipeline`'s `timings`,
and where the device time goes in one warm run of the pipeline on the
card.

The recorder. `run_pipeline` opens a run's recorder (`recording`) on its
thread; `span(name)` then adds the seconds of its block, by
time.perf_counter, to that run's dict under `<parent key>_<name>` (the
innermost open span's key; a top-level span's key is its name). A span
opened again in one run accumulates. A span records nothing outside a run
or on another thread (the join's pack workers). While a torch profiler is
recording, each span also opens `record_function("phi." + key)`, so its
host range lies in the same trace as the kernels and copies it launched.
A span never synchronises the device or reads anything back.

    python -m phi_tpu_torch.trace [-k 35]

Builds (or reuses) the synthetic instance of the reference's configuration
(49 haplotypes x 5 Mbp, 1x reads, `-k 31 -w 25 -R 100`; `-k` sets another
k, such as 35 for the wide rows3w route), runs the pipeline on cuda once
cold and once warm, then once more under torch.profiler, and prints one
JSON object:
  - `wall_s`: the warm run's `timings["total"]`, unprofiled, and
    `timings`: that run's whole `timings` (the phases and their spans);
  - `profiled_wall_s`: the same for the profiled run;
  - `busy_s`: the length of the union of the intervals of every kernel,
    copy and fill that ran on the card in the profiled run, so events that
    overlap count once;
  - `busy_share`: busy_s / wall_s, and `busy_share_profiled`:
    busy_s / profiled_wall_s (the profiler slows the host, not the card);
  - `by_name`: device milliseconds and event counts of the 25 largest
    event names (summed, not merged; names cut to 120 characters);
  - `busy_by_span`: per span key, the device's busy seconds inside that
    span's host ranges of the profiled run (a parent's include its
    children's);
  - `idle_by_span`: the profiled run's idle seconds of the device, each
    idle stretch put down to the innermost span open on the host then, or
    `other` where none was.
Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import functools
import json
import os
import subprocess
import sys
import threading
from time import perf_counter

import torch

SPAN_PREFIX = "phi."

_profiling = torch._C._autograd._profiler_enabled
_local = threading.local()


class _Run:
    __slots__ = ("timings", "key")

    def __init__(self):
        self.timings: dict[str, float] = {}
        self.key: str | None = None


@contextlib.contextmanager
def recording():
    """This thread's recorder for one run; yields the run's timings dict.
    An enclosing run's recorder is back in place after the block."""
    outer = getattr(_local, "run", None)
    run = _local.run = _Run()
    try:
        yield run.timings
    finally:
        _local.run = outer


class span:
    """`with span(name):` adds the block's seconds to the current run's
    timings under `<parent key>_<name>` (module docstring)."""

    __slots__ = ("name", "run", "parent", "key", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        run = self.run = getattr(_local, "run", None)
        if run is None:
            return self
        self.parent = run.key
        key = self.key = self.name if run.key is None \
            else f"{run.key}_{self.name}"
        run.key = key
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(SPAN_PREFIX + key)
            self.rf.__enter__()
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        run = self.run
        if run is None:
            return False
        dt = perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        run.timings[self.key] = run.timings.get(self.key, 0.0) + dt
        run.key = self.parent
        return False


def spanned(name: str):
    """A decorator: every call of the function is one span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


# the reference's published configuration (BASELINE.md)
HAPS, LENGTH, COVERAGE = 49, 5_000_000, 1.0


def card_line() -> str:
    """The first card's name and power limit as nvidia-smi gives them, or
    "" where it gives nothing."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ""
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else ""


def _merge(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def merged_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(e - s for s, e in _merge(intervals))


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


def span_ranges(prof) -> list[tuple[str, float, float]]:
    """(key, start_us, end_us) of the profiled spans' host ranges."""
    from torch.autograd import DeviceType
    n = len(SPAN_PREFIX)
    return [(e.name[n:], e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == DeviceType.CPU
            and e.name.startswith(SPAN_PREFIX)]


def busy_by_span(events, ranges) -> dict[str, float]:
    """Per span key, the microseconds of the union of the device events'
    intervals that lie inside the key's host ranges."""
    busy = _merge((s, e) for _, s, e in events)
    starts = [s for s, _ in busy]
    out: dict[str, float] = {}
    for key, a, b in ranges:
        t = 0.0
        for s, e in busy[max(0, bisect.bisect_right(starts, a) - 1):]:
            if s >= b:
                break
            t += max(0.0, min(e, b) - max(s, a))
        out[key] = out.get(key, 0.0) + t
    return out


def innermost(ranges, lo: float, hi: float) -> list[tuple[float, float,
                                                          str]]:
    """[lo, hi] cut into (start, end, key) pieces, each labelled with the
    innermost range open over it (the one opened last; the ranges of one
    thread nest), or "other" where none is."""
    out: list[tuple[float, float, str]] = []
    stack = [("other", hi)]
    t = lo

    def close(upto):
        nonlocal t
        if upto > t:
            out.append((t, upto, stack[-1][0]))
            t = upto

    for key, s, e in sorted(ranges, key=lambda r: (r[1], -r[2])):
        s, e = max(s, lo), min(e, hi)
        if s >= e:
            continue
        while stack[-1][1] <= s:
            close(stack[-1][1])
            stack.pop()
        close(s)
        stack.append((key, min(e, stack[-1][1])))
    while stack:
        close(stack[-1][1])
        stack.pop()
    return out


def idle_by_span(events, ranges, lo: float, hi: float) -> dict[str, float]:
    """The microseconds of [lo, hi] in which no device event ran, each
    idle stretch put down to the innermost range open over it, or
    "other"."""
    idle, t = [], lo
    for s, e in _merge((s, e) for _, s, e in events):
        if e <= lo:
            continue
        if s >= hi:
            break
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if hi > t:
        idle.append((t, hi))
    out: dict[str, float] = {}
    pieces = innermost(ranges, lo, hi)
    j = 0
    for a, b in idle:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        i = j
        while i < len(pieces) and pieces[i][0] < b:
            s, e, key = pieces[i]
            d = min(e, b) - max(s, a)
            if d > 0:
                out[key] = out.get(key, 0.0) + d
            i += 1
    return out


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
    events = device_events(prof)
    res = summarize(events, timings["total"], profiled)
    res["timings"] = timings
    ranges = span_ranges(prof)
    lo = min((s for _, s, _ in ranges), default=0.0)
    hi = max([e for _, _, e in ranges] + [e for _, _, e in events],
             default=lo)
    res["busy_by_span"] = {k: v / 1e6 for k, v in sorted(
        busy_by_span(events, ranges).items())}
    res["idle_by_span"] = {k: v / 1e6 for k, v in sorted(
        idle_by_span(events, ranges, lo, hi).items(), key=lambda kv: -kv[1])}
    res["by_name"] = [dict(d, name=d["name"][:120])
                      for d in res["by_name"][:25]]
    res["card"] = card_line()
    res["instance"] = {"haps": HAPS, "length": LENGTH, "coverage": COVERAGE,
                       "k": k}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
