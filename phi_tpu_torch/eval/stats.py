"""Variance-honest repeated-run measurement (the port's copy of
`phi_tpu/eval/stats.py`).

A shared host can swing the wall of identical runs by 2-3x, so
single-observation or best-of-N numbers are selection-biased. Every CSV
artifact reports median-of-N with dispersion instead: run_stats() repeats a
measurement adaptively (N>=5 whenever a single run is cheap enough) and
returns {n_runs, median, iqr, min, max, raw} — raw is always kept so the
artifact can be re-audited.

Mirrors the tuple-per-cell discipline of the reference's
data/plots/*.csv, which records single batch-node runs; on dedicated
batch nodes one observation is defensible, on a shared host it is not.
"""

from __future__ import annotations

import time
from statistics import median
from typing import Any, Callable


def summarize(times: list[float]) -> dict[str, Any]:
    s = sorted(times)
    n = len(s)
    q1 = s[max(0, (n - 1) // 4)]
    q3 = s[min(n - 1, (3 * (n - 1) + 2) // 4)]
    # raw_s stays in RUN order (the first observation is the cold one)
    return {"n_runs": n, "median_s": round(median(s), 3),
            "iqr_s": round(q3 - q1, 3), "min_s": round(s[0], 3),
            "max_s": round(s[-1], 3), "raw_s": [round(t, 3) for t in times]}


def run_stats(fn: Callable[[], Any], *, target_runs: int = 5,
              cheap_wall_s: float = 60.0, budget_s: float = 600.0,
              min_runs: int = 1) -> tuple[Any, dict[str, Any]]:
    """Call fn repeatedly and summarize its wall-clock.

    First run always happens; if it is cheaper than cheap_wall_s, keep
    going to target_runs total (while staying under budget_s). Returns
    (last fn result, stats dict)."""
    times: list[float] = []
    result = None
    t_start = time.time()
    while True:
        t0 = time.time()
        result = fn()
        times.append(time.time() - t0)
        n = len(times)
        if n >= target_runs or n >= min_runs and (
                times[0] >= cheap_wall_s
                or time.time() - t_start + times[-1] > budget_s):
            break
    return result, summarize(times)
