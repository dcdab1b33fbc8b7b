"""The readings that the limits in check.py are set from, for one cell,
in one process: for each seed, a short window at the cell's own load (as
many items as a run checks), then the check of the program's answers and
of the control's. The control is the reference put in the program's place
for the solve's numbers, computed in bfloat16, the precision below the
float32 the program's DP states; the other numbers are exact counts and
sequences, which a lower precision does not change. Not run by the
benchmark's own runs.

    python3 phibench/control.py --workload mhc49.batch-1x \\
        --seeds 11,12,13 [--items 4]

Prints one JSON line a seed: {"seed", "program": {number: reading},
"control": {number: reading}, "program_correct", "control_correct",
"items", ...}, where each `_correct` is check.passes at the committed
limits (check.limits of the cell's configuration): the program's has to
read true and the control's false.
"""

from __future__ import annotations

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or ".") == _HERE:
    sys.path[0] = os.path.dirname(_HERE)


def readings(cell: str, seeds: list[int], items: int | None = None,
             device: str = "cuda", **run_kw) -> list[dict]:
    import json
    import time

    from phibench import check, harness
    t0 = time.monotonic()
    run = harness.Run(cell, seeds[0], 1e9, False, device=device,
                      control=True, **run_kw)
    n = items or max(1, run.traffic.get("check", -1))
    lim = check.limits(run.config)
    out = []
    try:
        for seed in seeds:
            run.seed, run.records, run.window_s = seed, [], 0.0
            harness.setup(run)
            harness.window(run, lambda: time.monotonic() - t0, n)
            prog, ctl = harness.verify(run)
            out.append({"seed": seed, "program": prog, "control": ctl,
                        "program_correct": check.passes(prog, lim),
                        "control_correct": check.passes(ctl, lim),
                        "items": len(run.records),
                        "failed": sum(not r.get("ok") for r in run.records),
                        "walls": [r["wall_s"] for r in run.records]})
            print(json.dumps(out[-1]), flush=True)
    finally:
        harness.close(run)
        if run.log is not None:
            run.log.close()
        if run.tmp is not None:
            import shutil
            shutil.rmtree(run.tmp, ignore_errors=True)
    return out


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="phibench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--items", type=int, default=None)
    a = p.parse_args(argv)
    readings(a.workload, [int(s) for s in a.seeds.split(",")], a.items)
    return 0


if __name__ == "__main__":
    sys.exit(main())
