"""Arithmetic shared by the metric readers in metrics/. A reader returns
None where its run holds nothing to read, and the harness then leaves the
metric out."""

from __future__ import annotations

import math


def done(run) -> list[dict]:
    """The measured items that finished (raised nothing)."""
    return [r for r in run.records if r.get("out") is not None]


def per_item(run) -> float | None:
    """The window over the items completed in it."""
    n = len(done(run))
    return run.window_s / n if n else None


def nearest_rank(values, q: float) -> float | None:
    """The q-th percentile by nearest rank: the ceil(q / 100 * n)-th
    smallest value."""
    v = sorted(values)
    if not v:
        return None
    return v[max(1, math.ceil(q / 100 * len(v))) - 1]


def mean_timing(run, key: str) -> float | None:
    """The mean of one `timings` key over the completed items."""
    vals = [r["timings"][key] for r in done(run) if key in r["timings"]]
    return sum(vals) / len(vals) if vals else None


def idle_share(run) -> float | None:
    """Percent of the traced window in which no operation ran on the card."""
    t = run.trace
    if t is None or not run.on_card or t["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_us"] / t["window_us"])
