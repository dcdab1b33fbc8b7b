"""Reduction of a torch.profiler trace to the benchmark's device numbers.
`merged_us` (the union's length) and `device_events` copy
`phi_tpu_torch/trace.py`'s arithmetic; the rest clips them to the
measured items.

Each measured item runs inside a `record_function` range named
ITEM_PREFIX + <index> (the harness's own mark; the program adds none).
The window is the union of those ranges; a device interval counts only
inside it. An idle gap is a stretch of a range with no device interval in
it, labelled with the pipeline phase the host was in: the phases are laid
end to end from the start of the range by the item's own `timings`
(load_graph, load_reads, sketch_reads, sketch_haps, anchors, solve, emit);
before `startup` (a CLI child's launch) and after them `other`.
"""

from __future__ import annotations

ITEM_PREFIX = "phibench.item."
PHASES = ("load_graph", "load_reads", "sketch_reads", "sketch_haps",
          "anchors", "solve", "emit")
TOP = 10


def merge(intervals) -> list[tuple[float, float]]:
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
    return sum(e - s for s, e in merge(intervals))


def device_events(prof) -> list[tuple[str, float, float]]:
    """(name, start_us, end_us) of the profiled events that ran on the card
    (kernels, copies, fills); annotation ranges are left out."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def item_ranges(prof) -> dict[int, tuple[float, float]]:
    """index -> (start_us, end_us) of the harness's item ranges."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith(ITEM_PREFIX):
            out[int(e.name[len(ITEM_PREFIX):])] = (e.time_range.start,
                                                   e.time_range.end)
    return out


def _phase_bounds(start: float, timings: dict, lead_us: float):
    """(label, start_us, end_us) of the phases of one item."""
    bounds = []
    t = start
    if lead_us > 0:
        bounds.append(("startup", t, t + lead_us))
        t += lead_us
    for p in PHASES:
        d = timings.get(p, 0.0) * 1e6
        bounds.append((p, t, t + d))
        t += d
    return bounds


def _split(idle, bounds, end: float) -> list[tuple[str, float]]:
    """Each idle stretch cut at the phase bounds, a piece per phase."""
    cuts = [(name, s, e) for name, s, e in bounds if e > s]
    last = cuts[-1][2] if cuts else end
    cuts.append(("other", last, max(end, last)))
    out = []
    for a, b in idle:
        for name, s, e in cuts:
            lo, hi = max(a, s), min(b, e)
            if lo < hi:
                out.append((name, hi - lo))
    return out


def reduce(events, ranges: dict, timings: dict, leads: dict | None = None
           ) -> dict:
    """busy_us and window_us over the item ranges, device time by op name
    (clipped to the ranges), and every idle gap labelled by phase.
    timings[i] and leads[i] (us before the pipeline's entry) per item."""
    leads = leads or {}
    window = [(s, e) for s, e in ranges.values()]
    window_us = merged_us(window)
    busy, ops = [], {}
    wins = merge(window)
    for name, s, e in events:
        for ws, we in wins:
            a, b = max(s, ws), min(e, we)
            if a < b:
                busy.append((a, b))
                ops[name] = ops.get(name, 0.0) + (b - a)
    merged = merge(busy)
    gaps = []
    for i, (ws, we) in ranges.items():
        bounds = _phase_bounds(ws, timings.get(i, {}), leads.get(i, 0.0))
        idle, t = [], ws
        for s, e in merged:
            if e <= ws or s >= we:
                continue
            if s > t:
                idle.append((t, s))
            t = max(t, e)
        if we > t:
            idle.append((t, we))
        gaps += _split(idle, bounds, we)
    return {"busy_us": merged_us(busy), "window_us": window_us, "ops": ops,
            "gaps": sorted(gaps, key=lambda g: -g[1])[:5 * TOP]}


def combine(parts: list[dict]) -> dict:
    """Several items' reductions (a CLI child's each) as one."""
    ops: dict = {}
    for p in parts:
        for k, v in p["ops"].items():
            ops[k] = ops.get(k, 0.0) + v
    return {"busy_us": sum(p["busy_us"] for p in parts),
            "window_us": sum(p["window_us"] for p in parts), "ops": ops,
            "gaps": sorted((tuple(g) for p in parts for g in p["gaps"]),
                           key=lambda g: -g[1])}


def breakdown(red: dict) -> dict:
    """The result line's breakdown: the device ops that took most time,
    and the longest idle gaps, in seconds."""
    ops = sorted(red["ops"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:200], v / 1e6] for n, v in ops],
            "idle_gaps": [[n, v / 1e6] for n, v in red["gaps"][:TOP]]}
