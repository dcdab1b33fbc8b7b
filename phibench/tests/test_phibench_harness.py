"""The harness end to end on the CPU, at a tiny panel, with the port on the
CPU: a rehearsal of each cell's driver, the reference against the port,
new parts added as files only, and the faults and the control that the
check has to catch."""

import json
import os
import shutil

import pytest
import torch

from phibench import check, synth
from phibench import reference as ref
from phibench.tests.phibench_tiny import BENCH, make_root, run_cell

DEVICE_METRICS = {"peak_mem_gb", "rows_roofline",
                  "device_idle_share.sample", "device_idle_share.resolve"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="module")
def control_root(tmp_path_factory):
    """A panel large enough that bfloat16 cannot hold the solve's sums
    exactly (over 256 model k-mers in the resolve cell's fixed sample)."""
    return make_root(str(tmp_path_factory.mktemp("ctl")), length=120000)


@pytest.mark.parametrize("cell,trace", [
    ("mhc49.batch-1x", False), ("mhc49.batch-1x", True),
    ("mhc49.resolve", False), ("mhc49.resolve", True),
    ("mhc49.cli-1x", False), ("chr21_49.batch-2x", False)])
def test_rehearsal_on_the_cpu(root, cell, trace):
    run, res = run_cell(root, cell, trace=trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = run.per_layer if trace else run.end_to_end
    got = set(res["metrics"])
    assert got == {m["name"] for m in want} - DEVICE_METRICS
    assert not got & DEVICE_METRICS
    assert list(res)[-1] == "checks"
    for name, (val, lim) in res["checks"].items():
        assert val <= lim, name


def test_reference_matches_the_port(tmp_path):
    from phibench import program
    panel = synth.make_panel(5, 40000, 7, 0.01, 0.05, 30)
    gfa = str(tmp_path / "p.gfa")
    synth.write_gfa(panel, gfa)
    pi = ref.index_panel(panel, 31, 25, "cpu")
    with open(os.path.join(BENCH, "traffic", "batch-1x.json")) as f:
        traffic = json.load(f)

    class R:
        params = {"k": 31, "w": 25, "R": 100, "T": 1.0}
        device = "cpu"
    R.gfa = gfa
    for i in range(3):
        s = synth.make_sample(panel, 99, 1, i, traffic)
        fq, fa = str(tmp_path / f"{i}.fq.gz"), str(tmp_path / f"{i}.fa")
        synth.write_fastq(s.reads, fq)
        res = program.pipeline(program.argv(R, fq, fa))
        out = program.outputs(res, fa, 100.0, 0.99)
        an = ref.anchors(pi, ref.read_spectrum(s.reads, 31, 25, "cpu"), 1.0)
        b = ref.relaxed_bound(pi, an, 100.0, torch.float64)
        vals = check.judge(out, an, b, pi, panel)
        assert check.passes(vals, check.limits({"certify_tol": 0.99})), vals
        assert out["minimizers"] == an.minimizers
        assert out["bound"] == b


def test_a_new_cell_and_metric_are_new_files_only(root, tmp_path):
    new = str(tmp_path / "r")
    shutil.copytree(root, new)
    with open(os.path.join(new, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["workloads"].append({"name": "tiny.batch-3x", "config": "tiny",
                             "traffic": "batch-3x", "chips": 1,
                             "why": "a test cell"})
    man["per_layer"].append({"name": "items_n", "unit": "count",
                             "better": "higher", "source": "host_clock",
                             "layer": "pipeline", "moves": "inference_s",
                             "workloads": ["tiny.batch-3x"]})
    man["end_to_end"][0]["workloads"].append("tiny.batch-3x")
    with open(os.path.join(new, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    t = json.load(open(os.path.join(BENCH, "traffic", "batch-1x.json")))
    t.update(coverage=3.0, check=1)
    with open(os.path.join(new, "phibench", "traffic", "batch-3x.json"),
              "w") as f:
        json.dump(t, f)
    with open(os.path.join(new, "phibench", "metrics", "items_n.py"),
              "w") as f:
        f.write("def read(run):\n    return len(run.records)\n")
    run, res = run_cell(new, "tiny.batch-3x", trace=True)
    assert res["correct"]
    assert res["metrics"]["items_n"]["value"] == res["attempted"]
    run, res = run_cell(new, "tiny.batch-3x")
    assert set(res["metrics"]) == {"inference_s", "setup_s"}


def _halve_reads(monkeypatch):
    from phi_tpu_torch import pipeline
    real = pipeline.sketch_read_concat

    def half(concat, off, *a, **kw):
        n = (len(off) - 1) // 2
        return real(concat[:off[n]], off[:n + 1], *a, **kw)
    monkeypatch.setattr(pipeline, "sketch_read_concat", half)


def _alter_fasta(monkeypatch):
    from phi_tpu_torch import pipeline
    real = pipeline.write_fasta

    def altered(path, name, seq, *a, **kw):
        seq = seq[:100] + ("A" if seq[100] != "A" else "C") + seq[101:]
        return real(path, name, seq, *a, **kw)
    monkeypatch.setattr(pipeline, "write_fasta", altered)


def _alter_path(monkeypatch):
    from phi_tpu_torch import pipeline
    real = pipeline._solve_with_refinement

    def altered(graph, *a, **kw):
        res = real(graph, *a, **kw)
        h, q, p = res.segments[0]
        res.segments[0] = ((h + 1) % graph.num_walks, q, p)
        return res
    monkeypatch.setattr(pipeline, "_solve_with_refinement", altered)


@pytest.mark.parametrize("fault,numbers", [
    (_halve_reads, ["spectrum"]), (_alter_fasta, ["fasta"]),
    (_alter_path, ["path", "fasta", "report"])])
def test_a_fault_in_the_timed_path_reads_not_correct(root, monkeypatch,
                                                     fault, numbers):
    fault(monkeypatch)
    run, res = run_cell(root, "mhc49.batch-1x")
    assert not res["correct"]
    assert any(res["checks"][n][0] > res["checks"][n][1] for n in numbers)


@pytest.mark.parametrize("cell", ["mhc49.batch-1x", "mhc49.resolve"])
def test_the_control_fails_the_check(control_root, cell):
    """At a size a test holds, the control's bfloat16 errors are small, so
    its limits are set here by the rule check.py's come from (between the
    program's largest reading and the control's smallest, nearer the
    control's), and the control has to fail them."""
    from phibench import control
    lim = check.limits({"certify_tol": 0.99})
    root = control_root
    recs = list(control.readings(cell, [2**31 + 1, 2**33 + 2, 17, 5], None,
                                 device="cpu", root=root,
                                 cache_root=os.path.join(root, "cache")))
    for r in recs:
        assert check.passes(r["program"], lim), r
    for n in ("bound", "objective"):
        lower = max(r["program"][n] for r in recs)
        upper = [r["control"][n] for r in recs if r["control"][n] > lower]
        if upper:
            lim[n] = lower + 0.6 * (min(upper) - lower)
    assert any(not check.passes(r["control"], lim) for r in recs)


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """A short run of each mhc49 cell on the card (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import subprocess
    import sys
    root = os.path.dirname(BENCH)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]
                 if w["config"] == "mhc49"]
    for cell in cells:
        out = subprocess.run(
            [sys.executable, "phibench/run.py", "--workload", cell,
             "--seed", str(2**32 + 9), "--seconds", "3", "--trace", "0"],
            cwd=root, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.cuda
def test_the_control_fails_the_committed_limits_on_the_card():
    """At the cell's own size the control reads not correct at the limits
    check.py commits, where the program reads correct (skips without a
    card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from phibench import control
    recs = control.readings("mhc49.batch-1x", [2**32 + 21])
    assert all(r["program_correct"] for r in recs), recs
    assert not any(r["control_correct"] for r in recs), recs
