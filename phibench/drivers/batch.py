"""Back-to-back samples through `run_pipeline` in one process against one
panel, as the eval runners and a lab's batch on one card run them. Set-up
runs one warm-up sample (stream 0); the window's item i is sample i of
stream 1."""

from __future__ import annotations

import os

from phibench import program


def setup(run) -> None:
    reads = run.write_sample(0, 0)
    out = os.path.join(run.tmp, "warm.fa")
    program.pipeline(program.argv(run, reads, out))


def prepare(run, i: int) -> dict:
    return {"reads": run.write_sample(1, i),
            "out": os.path.join(run.tmp, f"out{i}.fa")}


def item(run, i: int, prep: dict) -> dict:
    R = run.params["R"]
    res = program.pipeline(program.argv(run, prep["reads"], prep["out"], R))
    out = program.outputs(res, prep["out"], R, run.config["certify_tol"])
    os.remove(prep["reads"])
    return {"ok": out["certified"], "timings": dict(res.timings),
            "out": out, "sample": [1, i]}


def close(run) -> None:
    program.clear_caches()
