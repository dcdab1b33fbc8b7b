"""One inference in a fresh process, as `python -m phi_tpu_torch.cli`
runs it, for the benchmark's CLI cell:

    python -m phibench.child OUT.json TRACE CERTIFY_TOL -- <cli arguments>

It parses the arguments with the CLI's own parser, runs the pipeline, and
writes OUT.json: the pipeline's timings, the answer (program.outputs),
the time its FASTA was on disk (`done_at`, seconds since the epoch), the
card's peak memory, the forbidden modules it loaded (guard.py), and
with TRACE 1 its device trace reduced (devtrace.reduce) and the seconds
the profiler's start took before the pipeline (`profiler_start_s`). Exit
code 0 when it wrote OUT.json.
"""

from __future__ import annotations

import json
import sys
import time


def main(argv: list[str]) -> int:
    t_entry = time.perf_counter()
    from phibench.run import process_age
    age_at_entry = process_age()
    out_json, trace = argv[0], argv[1] == "1"
    args = argv[argv.index("--") + 1:]
    import torch

    from phibench import devtrace, guard, program
    from phi_tpu_torch import cli
    ns = cli.build_parser().parse_args(args)
    on_card = ns.device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    prof, prof_s = None, 0.0
    if trace:
        t = time.perf_counter()
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
        prof_s = time.perf_counter() - t
    lead = time.perf_counter() - t_entry
    with torch.profiler.record_function(f"{devtrace.ITEM_PREFIX}0"):
        res = program.pipeline(args)
        if on_card:
            torch.cuda.synchronize()
    done_at = time.time()
    rec = {"timings": dict(res.timings), "lead_s": lead,
           "done_at": done_at, "profiler_start_s": prof_s,
           "age_at_entry_s": age_at_entry,
           "out": program.outputs(res, ns.out, ns.R, float(argv[2])),
           "peak_bytes": torch.cuda.max_memory_allocated() if on_card
           else None}
    if prof is not None:
        prof.__exit__(None, None, None)
        red = devtrace.reduce(devtrace.device_events(prof),
                              devtrace.item_ranges(prof),
                              {0: rec["timings"]})
        red["gaps"] = red["gaps"][:devtrace.TOP]
        rec["trace"] = red
    rec["forbidden"] = guard.forbidden()
    with open(out_json, "w") as f:
        json.dump(rec, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
