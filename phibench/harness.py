"""One run of one cell: set-up, the measured window, the check against the
reference, the metrics.

Everything that belongs to a configuration, a traffic mix or a metric is
found by name, so a new cell, configuration or metric is new files and new
entries of BENCHMARK.json:
  * BENCHMARK.json's cell -> its `config` and `traffic`;
  * phibench/configs/<config>.json: the panel's sizes and seed, the run's
    parameters (k, w, R, T) and the certification tolerance;
  * phibench/traffic/<traffic>.json: the driver and its parameters;
  * phibench/drivers/<driver>.py: setup(run), prepare(run, i),
    item(run, i, prep) and close(run);
  * phibench/metrics/<metric>.py: read(run) -> number or None.

The window is closed-loop: item i starts when item i - 1 has written its
FASTA, and no item starts once the measured time reaches `seconds`. The
clock stops while the benchmark writes the next sample (prepare), so the
window is the sum of the items' walls.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch

from phibench import check, devtrace, synth
from phibench import reference as ref

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str, reported: set | None = None) -> bool:
    """Whether a metric is reported in a cell: its `workloads` list, or,
    without one, every cell (an end-to-end metric) or every cell that
    reports the metric it moves (a per-layer metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


class Run:
    """The state of one run, which the drivers fill and the metric readers
    read: records (one a measured item), window_s, setup_s, peak_bytes
    (None off the card), cache_delta, trace (devtrace.reduce's dict, or
    None)."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", root: str = ROOT, control=False,
                 cache_root: str = synth.CACHE):
        self.root, self.cache_root = root, cache_root
        bench = os.path.join(root, "phibench")
        manifest = _read(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in manifest["workloads"]}
        if cell not in cells:
            raise ValueError(f"no workload {cell!r} in BENCHMARK.json")
        self.cell = cells[cell]
        self.config = _read(os.path.join(bench, "configs",
                                         self.cell["config"] + ".json"))
        self.traffic = _read(os.path.join(bench, "traffic",
                                          self.cell["traffic"] + ".json"))
        self.driver = load_module(
            os.path.join(bench, "drivers", self.traffic["driver"] + ".py"),
            "phibench_driver_" + self.traffic["driver"])
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if applies(m, cell)]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if applies(m, cell, names)]
        self.metrics_dir = os.path.join(bench, "metrics")
        self.name, self.seed, self.seconds = cell, seed, seconds
        self.trace_on, self.device, self.control = trace, device, control
        self.params = self.config["params"]
        self.records: list[dict] = []
        self.window_s = 0.0
        self.setup_s = None
        self.peak_bytes = None
        self.setup_peak_bytes = 0
        self.cache_delta = None
        self.trace = None
        self.tmp = None
        self.log = None

    @property
    def on_card(self) -> bool:
        return torch.device(self.device).type == "cuda"

    @property
    def card_here(self) -> bool:
        """Whether this process runs the program on the card (a driver
        whose children run it sets IN_PROCESS False: this process then
        leaves the card to them until the check)."""
        return self.on_card and getattr(self.driver, "IN_PROCESS", True)

    def sample(self, stream: int, index: int, seed: int | None = None
               ) -> synth.Sample:
        """Sample `index` of stream `stream`, drawn from the run's seed or
        from `seed`."""
        return synth.make_sample(self.panel,
                                 self.seed if seed is None else seed,
                                 stream, index, self.traffic)

    def write_sample(self, stream: int, index: int, seed: int | None = None
                     ) -> str:
        path = os.path.join(self.tmp, f"s{stream}_{index}.fq.gz")
        synth.write_fastq(self.sample(stream, index, seed).reads, path)
        return path


def setup(run: Run) -> None:
    if run.tmp is None:
        run.tmp = tempfile.mkdtemp(prefix="phibench-",
                                   dir=os.environ.get("TMPDIR"))
        run.log = open(os.path.join(run.tmp, "program.log"), "w")
        run.panel, run.gfa = synth.load_panel(run.config, run.cache_root)
        run.walk_bases = int(sum(run.panel.node_len[w].sum()
                                 for w in run.panel.walks))
    with contextlib.redirect_stderr(run.log):
        run.driver.setup(run)
    if run.card_here:
        torch.cuda.synchronize()
        run.setup_peak_bytes = torch.cuda.max_memory_allocated()


def window(run: Run, now, max_items: int | None = None) -> None:
    """The measured window; `now()` is the age of the process in seconds.
    `max_items` ends it after that many items (the control's readings)."""
    prof = None
    if run.trace_on and getattr(run.driver, "IN_PROCESS", True):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if run.on_card:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    from phi_tpu_torch.eval.onchip import cache_counts, cache_delta
    before = cache_counts()
    if run.card_here:
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = now()
    i = 0
    with contextlib.ExitStack() as stack:
        stack.enter_context(contextlib.redirect_stderr(run.log))
        if prof is not None:
            stack.enter_context(prof)
        while run.window_s < run.seconds and (max_items is None
                                              or i < max_items):
            prep = run.driver.prepare(run, i)
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(
                        f"{devtrace.ITEM_PREFIX}{i}"):
                    rec = run.driver.item(run, i, prep)
                    if run.card_here:
                        torch.cuda.synchronize()
            except Exception:  # noqa: BLE001 - a failed item is counted
                rec = {"ok": False, "error": traceback.format_exc()}
            rec["wall_s"] = time.perf_counter() - t0
            rec["index"] = i
            run.window_s += rec["wall_s"]
            run.records.append(rec)
            i += 1
    run.cache_delta = cache_delta(before, cache_counts())
    if run.card_here:
        run.peak_bytes = torch.cuda.max_memory_allocated()
    if prof is not None:
        timings = {r["index"]: r.get("timings", {}) for r in run.records}
        run.trace = devtrace.reduce(devtrace.device_events(prof),
                                    devtrace.item_ranges(prof), timings)
    elif run.trace_on:
        run.trace = devtrace.combine(run.child_traces)


def close(run: Run) -> None:
    run.driver.close(run)
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()


def choose(run: Run) -> list[dict]:
    """The items to check: every one where the traffic's `check` is -1,
    else that many drawn from the seed, the longest among them."""
    done = [r for r in run.records if r.get("out") is not None]
    n = run.traffic.get("check", -1)
    if n < 0 or len(done) <= n:
        return done
    longest = max(range(len(done)), key=lambda j: done[j]["wall_s"])
    rest = [j for j in range(len(done)) if j != longest]
    rng = np.random.default_rng([run.seed, 7])
    pick = [longest] + rng.choice(rest, n - 1, replace=False).tolist()
    return [done[j] for j in sorted(pick)]


def verify(run: Run) -> tuple[dict, dict | None]:
    """The worst reading of each compared number over the checked items
    (and, with run.control, the control's: the reference in bfloat16 in
    the program's place for the bound and the objective)."""
    k, w = run.params["k"], run.params["w"]
    pi = ref.index_panel(run.panel, k, w, run.device)
    sources = ref.switch_sources(pi)
    rows, ctl = [], []
    by_sample: dict = {}
    bounds: dict = {}
    for rec in choose(run):
        out = rec["out"]
        key = tuple(rec["sample"])
        if key not in by_sample:
            reads = run.sample(*key).reads
            sp = ref.read_spectrum(reads, k, w, run.device)
            by_sample[key] = ref.anchors(pi, sp, run.params["T"])
        an = by_sample[key]
        if (key, out["R"]) not in bounds:
            bounds[(key, out["R"])] = ref.relaxed_bound(
                pi, an, out["R"], torch.float64, sources)
        b = bounds[(key, out["R"])]
        rows.append(check.judge(out, an, b, pi, run.panel))
        if run.control:
            segs = [tuple(map(int, s)) for s in out["segments"]]
            low = dict(out, bound=ref.relaxed_bound(
                pi, an, out["R"], torch.bfloat16, sources),
                objective=ref.path_objective(an, segs, out["R"],
                                             torch.bfloat16))
            ctl.append(check.judge(low, an, b, pi, run.panel))
    return check.worst(rows), (check.worst(ctl) if run.control else None)


def metrics(run: Run, specs: list[dict]) -> dict:
    out = {}
    for m in specs:
        mod = load_module(os.path.join(run.metrics_dir, m["name"] + ".py"),
                          "phibench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def execute(run: Run, now) -> dict:
    """Set-up, window, check and metrics of one run; the result line's
    object, with `checks` last."""
    try:
        setup(run)
        window(run, now)
        close(run)
        values, control = verify(run)
        lim = check.limits(run.config)
        attempted = len(run.records)
        failed = sum(1 for r in run.records if not r.get("ok"))
        # an item that raised never answered, and an uncertified one broke
        # the configuration's guarantee: either is not correct
        correct = check.passes(values, lim) and failed == 0
        specs = run.per_layer if run.trace_on else run.end_to_end
        res = {"correct": correct, "attempted": attempted, "failed": failed,
               "metrics": metrics(run, specs)}
        dev = {"platform": "gpu" if run.on_card else "cpu",
               "kind": torch.cuda.get_device_name(0) if run.on_card
               else "cpu",
               "count": int(run.cell.get("chips", 1)),
               "memory_peak_bytes": max(run.peak_bytes or 0,
                                        run.setup_peak_bytes)}
        if run.trace is not None:
            dev["busy_s"] = run.trace["busy_us"] / 1e6
            dev["window_s"] = run.trace["window_us"] / 1e6
            res["breakdown"] = devtrace.breakdown(run.trace)
        res["device"] = dev
        if control is not None:
            res["control"] = control
        res["errors"] = [r["error"][-2000:] for r in run.records
                         if r.get("error")][:3]
        res["checks"] = {n: [values.get(n), lim[n]] for n in lim}
        return res
    finally:
        if run.log is not None:
            run.log.close()
        if run.tmp is not None:
            shutil.rmtree(run.tmp, ignore_errors=True)
