"""Each sample through a fresh process, as the reference's own
data/run_batch_*.py start one PHI process per sample: phibench/child.py
calls the port's CLI parser and pipeline and reports back. Every process
pays the interpreter's and torch's start, the CUDA context and the
libraries' load, and finds the cross-run caches empty. Set-up runs one
warm-up child (stream 0); the window's item i is sample i of stream 1,
its wall from the launch to the child's exit."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from phibench import harness, program

# the program runs in the children; this process leaves the card to them
IN_PROCESS = False


def _child(run, reads: str, out: str, tag: str) -> dict:
    path = os.path.join(run.tmp, f"{tag}.json")
    cmd = [sys.executable, "-m", "phibench.child", path,
           "1" if run.trace_on else "0", str(run.config["certify_tol"]),
           "--"] + program.argv(run, reads, out)
    with open(os.path.join(run.tmp, f"{tag}.log"), "w") as log:
        launch_at = time.time()
        proc = subprocess.run(cmd, cwd=harness.ROOT, stdout=log, stderr=log)
    if proc.returncode != 0:
        with open(os.path.join(run.tmp, f"{tag}.log")) as f:
            tail = f.read()[-2000:]
        raise RuntimeError(f"child exited {proc.returncode}: {tail}")
    with open(path) as f:
        rec = json.load(f)
    rec["launch_at"] = launch_at
    return rec


def setup(run) -> None:
    run.child_traces = []
    run.child_forbidden = []
    reads = run.write_sample(0, 0)
    rec = _child(run, reads, os.path.join(run.tmp, "warm.fa"), "warm")
    run.child_forbidden += rec["forbidden"]
    run.setup_peak_bytes = rec["peak_bytes"] or 0


def prepare(run, i: int) -> dict:
    return {"reads": run.write_sample(1, i),
            "out": os.path.join(run.tmp, f"out{i}.fa")}


def item(run, i: int, prep: dict) -> dict:
    rec = _child(run, prep["reads"], prep["out"], f"c{i}")
    os.remove(prep["reads"])
    run.child_forbidden += rec["forbidden"]
    if rec["peak_bytes"] is not None:
        run.peak_bytes = max(run.peak_bytes or 0, rec["peak_bytes"])
    if "trace" in rec:
        run.child_traces.append(rec["trace"])
    return {"ok": rec["out"]["certified"], "timings": rec["timings"],
            "lead_s": rec["lead_s"], "age_at_entry_s": rec["age_at_entry_s"],
            "to_fasta_s": rec["done_at"] - rec["launch_at"]
            - rec["profiler_start_s"],
            "out": rec["out"], "sample": [1, i]}


def close(run) -> None:
    pass
