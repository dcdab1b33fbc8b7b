"""Re-solves of one sample's index with --load-index, as a user tuning the
recombination penalty sends them. The saved sample is part of the
deployment, like the panel: sample 0 of stream 0 drawn from the
configuration's panel seed, so every run re-solves the same index and its
device memory does not hang on --seed. Set-up saves its index with
--save-index and re-solves it once at the configuration's R; the window's
item i re-solves it at traffic["R"][(offset + i) % n], the offset drawn
from --seed."""

from __future__ import annotations

import os

import numpy as np

from phibench import program


def setup(run) -> None:
    run.index_seed = int(run.config["panel"]["seed"])
    reads = run.write_sample(0, 0, run.index_seed)
    run.index = os.path.join(run.tmp, "index.npz")
    out = os.path.join(run.tmp, "save.fa")
    program.pipeline(program.argv(run, reads, out,
                                  extra=["--save-index", run.index]))
    os.remove(reads)
    program.pipeline(program.argv(run, None, out,
                                  extra=["--load-index", run.index]))
    run.offset = int(np.random.default_rng([run.seed, 3]).integers(
        len(run.traffic["R"])))


def prepare(run, i: int) -> dict:
    ladder = run.traffic["R"]
    return {"R": ladder[(run.offset + i) % len(ladder)],
            "out": os.path.join(run.tmp, f"out{i}.fa")}


def item(run, i: int, prep: dict) -> dict:
    R = prep["R"]
    res = program.pipeline(program.argv(
        run, None, prep["out"], R, extra=["--load-index", run.index]))
    out = program.outputs(res, prep["out"], R, run.config["certify_tol"])
    return {"ok": out["certified"], "timings": dict(res.timings),
            "out": out, "sample": [0, 0, run.index_seed]}


def close(run) -> None:
    program.clear_caches()
