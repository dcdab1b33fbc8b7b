"""The port's ground-truth chain (eval.groundtruth, eval.floor_diag,
eval.merge_gt) against phi_tpu's on the CPU, compared exactly (integers,
strings, file bytes) with the walls left out:

- `infer_cell` on tests/test_eval.py's held-out panel (4 walks x 60,000
  bp, CACHE_DIR in the test's directory) at 2x under each error model and
  with a forced escalation; os.environ as before afterwards, also when the
  escalated run raises;
- `run_grid` over 2 synthetic held-out truths x {0.5, 2}x x 1 seed (the
  port reads them through `truth_dir`, phi_tpu through a patched
  `load_truth`): the result JSON and `write_outputs`' files; `panel_floor`
  and `panel_floor_cached` on a miss and on a hit, the cache in the
  test's directory;
- `merge` of the recorded shards in bench_results/gt_parts for each error
  model into the test's directory: byte-equal files and the cell counts;
  `write_outputs` of bench_results/groundtruth_r05.json and `to_md` of
  bench_results/floor_diag_r05.json (read only);
- `diagnose` on one synthetic truth at 2x with PANEL_GFA patched in both
  packages;
- the CLIs: exit 1 with [E::main] on cuda without a card, and with
  --device cpu the same JSON line as phi_tpu's;
- chip_smoke.py's gt_build (phase 16's panel, truths and floors) at a
  small size, its floors equal to phi_tpu's `panel_floor`.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import phi_tpu.eval.floor_diag as jdiag  # noqa: E402
import phi_tpu.eval.groundtruth as jgt  # noqa: E402
import phi_tpu.eval.merge_gt as jmerge  # noqa: E402
from phi_tpu.config import Options as JaxOptions  # noqa: E402
from phi_tpu_torch.config import Options  # noqa: E402
from phi_tpu_torch.eval import floor_diag, groundtruth, merge_gt, scale  # noqa: E402
from phi_tpu_torch.graph.pangenome import tensorize  # noqa: E402
from phi_tpu_torch.io.gfa import read_gfa  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "bench_results")
TRUTHS = ("APD", "COX")


def _untimed(d: dict) -> dict:
    return {k: v for k, v in d.items() if k != "wall_s"}


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """tests/test_eval.py's held-out panel (4 walks x 60,000 bp, seed 1),
    its truth, and two more held-out truths (APD, COX: 3-break mosaics of
    the walks with private SNPs at 5e-4) as {sample}.fasta.gz."""
    d = tmp_path_factory.mktemp("gt")
    saved = scale.CACHE_DIR
    scale.CACHE_DIR = str(d / "cache")
    try:
        inst = scale.build_heldout_instance(4, 60_000, [], seed=1)
    finally:
        scale.CACHE_DIR = saved
    from phi_tpu_torch.eval.edits import _read_fasta_first_seq
    g = tensorize(read_gfa(inst["gfa"]))
    haps = [g.path_seq(g.walk_mat[h, :g.walk_len[h]])
            for h in range(g.num_walks)]
    truth_dir = d / "truth"
    truth_dir.mkdir()
    for i, sample in enumerate(TRUTHS):
        seq = scale.mosaic_target(np.random.default_rng(100 + i), haps,
                                  60_000, 3, 5e-4)
        with gzip.open(truth_dir / f"{sample}.fasta.gz", "wt") as f:
            f.write(f">{sample}\n")
            for j in range(0, len(seq), 80):
                f.write(seq[j:j + 80] + "\n")
    return {"gfa": inst["gfa"], "truth": _read_fasta_first_seq(inst["truth"]),
            "truth_dir": str(truth_dir), "graph": g}


@pytest.mark.parametrize("model,tol", [
    ("subs", 0.99), ("indel", 0.99), ("longread", 0.99), ("subs", -1.0)],
    ids=["subs", "indel", "longread", "forced_escalation"])
def test_infer_cell_matches_jax(panel, model, tol):
    em = groundtruth.ERROR_MODELS[model]
    assert em == jgt.ERROR_MODELS[model]
    kw = dict(error_rate=em["error_rate"], read_len=em["read_len"],
              indel_rate=em["indel_rate"], escalate_tol=tol)
    before = dict(os.environ)
    got = groundtruth.infer_cell(panel["gfa"], panel["truth"], 2.0, 7,
                                 opt=Options(lagrangian_rounds=2),
                                 device="cpu", **kw)
    assert dict(os.environ) == before
    want = jgt.infer_cell(panel["gfa"], panel["truth"], 2.0, 7,
                          opt=JaxOptions(lagrangian_rounds=2), **kw)
    assert list(got) == list(want)
    assert _untimed(got) == _untimed(want)
    assert (got["edit"], got["recombinations"], got["gap"]) == (126, 1, 0.0)
    assert got["escalated"] == (tol < 0)


def test_escalation_restores_environ_when_the_run_raises(panel, monkeypatch):
    """The escalated run sees _ESCALATION_ENV; afterwards a variable set
    before keeps its value and the unset ones are unset again, also when
    that run raises."""
    from phi_tpu_torch import pipeline
    monkeypatch.setenv("PHI_TPU_BNB_NODES", "7")
    monkeypatch.delenv("PHI_TPU_SUBGRAD_ITERS", raising=False)
    monkeypatch.delenv("PHI_TPU_BNB_SECS", raising=False)
    before = dict(os.environ)
    real, seen = pipeline.run_pipeline, []

    def second_raises(*args, **kwargs):
        seen.append({k: os.environ.get(k)
                     for k in groundtruth._ESCALATION_ENV})
        if len(seen) == 2:
            raise RuntimeError("escalated run failed")
        return real(*args, **kwargs)

    monkeypatch.setattr(pipeline, "run_pipeline", second_raises)
    with pytest.raises(RuntimeError, match="escalated run failed"):
        groundtruth.infer_cell(panel["gfa"], panel["truth"], 2.0, 7,
                               opt=Options(lagrangian_rounds=2),
                               escalate_tol=-1.0, device="cpu")
    assert dict(os.environ) == before
    assert seen == [{"PHI_TPU_SUBGRAD_ITERS": None, "PHI_TPU_BNB_NODES": "7",
                     "PHI_TPU_BNB_SECS": None},
                    groundtruth._ESCALATION_ENV]


def _jax_truths(monkeypatch, truth_dir):
    real = jgt.load_truth
    monkeypatch.setattr(jgt, "load_truth",
                        lambda sample: real(sample, truth_dir))


def _untimed_grid(res: dict) -> dict:
    return {**res, "cells": [_untimed(c) for c in res["cells"]]}


def test_run_grid_and_write_outputs_match_jax(panel, tmp_path, monkeypatch):
    """Each package in a working directory of its own, so each fills its
    own floor cache (bench_results/.floors_cache.json there)."""
    kw = dict(samples=TRUTHS, coverages=[0.5, 2.0], seeds=1,
              gfa_path=panel["gfa"], progress=False)
    # the record names the module's panel, a deployment path: the same here
    monkeypatch.setattr(groundtruth, "PANEL_GFA", jgt.PANEL_GFA)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    got = groundtruth.run_grid(**kw, device="cpu",
                               truth_dir=panel["truth_dir"])
    groundtruth.write_outputs(got, str(tmp_path / "port" / "out" / "gt"))
    monkeypatch.chdir(tmp_path / "jax")
    _jax_truths(monkeypatch, panel["truth_dir"])
    want = jgt.run_grid(**kw)
    jgt.write_outputs(want, str(tmp_path / "jax" / "out" / "gt"))
    assert _untimed_grid(got) == _untimed_grid(want)
    assert [c["sample"] for c in got["cells"]] == ["APD", "APD", "COX", "COX"]
    assert all(c["certified"] for c in got["cells"])
    for name in ("bench_results/.floors_cache.json", "out/gt.md"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert json.loads((tmp_path / "port" / "out/gt.json").read_text())[
        "floors"] == got["floors"]


def test_panel_floor_and_its_cache_match_jax(panel, tmp_path):
    from phi_tpu.graph import tensorize as jtensorize
    from phi_tpu.io.gfa import read_gfa as jread_gfa
    jgraph = jtensorize(jread_gfa(panel["gfa"]))
    truth = groundtruth.load_truth("COX", panel["truth_dir"])
    assert truth == jgt.load_truth("COX", panel["truth_dir"])
    want = jgt.panel_floor(jgraph, truth)
    assert groundtruth.panel_floor(panel["graph"], truth) == want
    assert want[1] > 0
    for pkg, graph in (("port", panel["graph"]), ("jax", jgraph)):
        mod = groundtruth if pkg == "port" else jgt
        cache = str(tmp_path / pkg / "floors.json")
        for _ in ("miss", "hit"):
            assert mod.panel_floor_cached(graph, truth, "COX", panel["gfa"],
                                          cache_path=cache) == want
    assert (tmp_path / "port" / "floors.json").read_bytes() == \
        (tmp_path / "jax" / "floors.json").read_bytes()
    # a hit reads the cache and skips the panel
    assert groundtruth.panel_floor_cached(
        None, truth, "COX", panel["gfa"],
        cache_path=str(tmp_path / "port" / "floors.json")) == want


@pytest.mark.parametrize("model,counts", [
    ("subs", (48, 33, 46)), ("indel", (48, 33, 46)),
    ("longread", (24, 14, 24))])
def test_merge_of_the_recorded_shards_matches_jax(tmp_path, capsys, model,
                                                  counts):
    parts = os.path.join(RESULTS, "gt_parts")
    got = merge_gt.merge(parts, model, str(tmp_path / "port" / model))
    want = jmerge.merge(parts, model, str(tmp_path / "jax" / model))
    assert got == want
    for ext in (".json", ".md"):
        assert (tmp_path / "port" / (model + ext)).read_bytes() == \
            (tmp_path / "jax" / (model + ext)).read_bytes()
    cells = got["cells"]
    assert (len(cells), sum(c["certified"] for c in cells),
            sum(c["beats_floor"] for c in cells)) == counts
    capsys.readouterr()
    args = ["--parts", parts, "--model", model]
    assert merge_gt.main(args + ["--out", str(tmp_path / "p2")]) == 0
    out_port = capsys.readouterr().out
    assert jmerge.main(args + ["--out", str(tmp_path / "j2")]) == 0
    assert out_port == capsys.readouterr().out
    assert json.loads(out_port) == dict(zip(
        ("cells", "certified", "beats_floor"), counts))


def test_merge_without_shards(tmp_path, capsys):
    assert merge_gt.merge(str(tmp_path), "subs", str(tmp_path / "x")) is None
    err = capsys.readouterr().err
    assert err.count("[merge-gt] missing shard") == 8
    assert merge_gt.main(["--parts", str(tmp_path), "--model", "subs",
                          "--out", str(tmp_path / "x")]) == 1


def test_write_outputs_and_to_md_of_the_records_match_jax(tmp_path):
    with open(os.path.join(RESULTS, "groundtruth_r05.json")) as f:
        rec = json.load(f)
    groundtruth.write_outputs(rec, str(tmp_path / "port" / "gt"))
    jgt.write_outputs(rec, str(tmp_path / "jax" / "gt"))
    for ext in (".json", ".md"):
        assert (tmp_path / "port" / ("gt" + ext)).read_bytes() == \
            (tmp_path / "jax" / ("gt" + ext)).read_bytes()
    with open(os.path.join(RESULTS, "floor_diag_r05.json")) as f:
        diag = json.load(f)
    assert floor_diag.to_md(diag) == jdiag.to_md(diag)
    assert floor_diag.DIAG_SAMPLES == jdiag.DIAG_SAMPLES


def test_diagnose_matches_jax(panel, tmp_path, monkeypatch):
    monkeypatch.setattr(groundtruth, "PANEL_GFA", panel["gfa"])
    monkeypatch.setattr(jgt, "PANEL_GFA", panel["gfa"])
    _jax_truths(monkeypatch, panel["truth_dir"])
    monkeypatch.chdir(tmp_path)
    kw = dict(samples=("APD",), coverage=2.0, progress=False)
    got = floor_diag.diagnose(**kw, device="cpu",
                              truth_dir=panel["truth_dir"])
    want = jdiag.diagnose(**kw)
    assert [_untimed(r) for r in got["rows"]] == \
        [_untimed(r) for r in want["rows"]]
    assert {k: v for k, v in got.items() if k != "rows"} == \
        {k: v for k, v in want.items() if k != "rows"}
    row = got["rows"][0]
    assert row["inferred_10x_edit"] < row["floor_edit"]


@pytest.mark.parametrize("cli", ["groundtruth", "floor_diag"])
def test_cli_cuda_without_card_exits_1(tmp_path, capsys, monkeypatch, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    mod = groundtruth if cli == "groundtruth" else floor_diag
    assert mod.main(["--out", str(tmp_path / "out")]) == 1
    captured = capsys.readouterr()
    assert captured.err.startswith("[E::main]") and "no CUDA device" in \
        captured.err
    assert captured.out == "" and os.listdir(tmp_path) == []


def test_groundtruth_cli_on_cpu_matches_jax(panel, tmp_path, capsys,
                                            monkeypatch):
    monkeypatch.setattr(groundtruth, "GROUND_TRUTH_DIR", panel["truth_dir"])
    _jax_truths(monkeypatch, panel["truth_dir"])
    monkeypatch.chdir(tmp_path)
    args = ["--samples", "COX", "--coverages", "2", "--seeds", "1",
            "--gfa", panel["gfa"], "--error-model", "indel"]
    assert groundtruth.main(args + ["--out", "port/gt",
                                    "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jgt.main(args + ["--out", "jax/gt"]) == 0
    assert got == capsys.readouterr().out
    assert json.loads(got) == {"cells": 1, "beats_floor": 1,
                               "all_certified": True}
    assert (tmp_path / "port/gt.md").read_bytes() == \
        (tmp_path / "jax/gt.md").read_bytes()


def test_floor_diag_cli_on_cpu_matches_jax(panel, tmp_path, capsys,
                                           monkeypatch):
    monkeypatch.setattr(groundtruth, "PANEL_GFA", panel["gfa"])
    monkeypatch.setattr(jgt, "PANEL_GFA", panel["gfa"])
    monkeypatch.setattr(groundtruth, "GROUND_TRUTH_DIR", panel["truth_dir"])
    _jax_truths(monkeypatch, panel["truth_dir"])
    monkeypatch.chdir(tmp_path)
    assert floor_diag.main(["--samples", "COX", "--out", "port/diag",
                            "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jdiag.main(["--samples", "COX", "--out", "jax/diag"]) == 0
    assert got == capsys.readouterr().out
    assert json.loads(got)["rows"] == 1
    assert (tmp_path / "port/diag.md").read_bytes() == \
        (tmp_path / "jax/diag.md").read_bytes()


def test_smoke_panel_build_and_its_floors(tmp_path):
    """chip_smoke.py's gt_build (phase 16's inputs) at 5 walks x 30 kbp:
    the truths it writes are the mosaics it floored, and each floor in its
    cache is phi_tpu's panel_floor of that truth."""
    import importlib.util
    from phi_tpu.graph import tensorize as jtensorize
    from phi_tpu.io.gfa import read_gfa as jread_gfa
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    d = str(tmp_path / "gt")
    built = smoke.gt_build(d, 5, 30_000)
    panel = os.path.join(d, "panel.gfa")
    jgraph = jtensorize(jread_gfa(panel))
    assert jgraph.num_walks == 5
    with open(os.path.join(d, "bench_results", ".floors_cache.json")) as f:
        cache = json.load(f)
    assert len(cache) == len(smoke.GT_SAMPLES) == 2
    for sample in smoke.GT_SAMPLES:
        truth = groundtruth.load_truth(sample, d)
        assert abs(len(truth) - 30_000) < 300
        hap, ed = jgt.panel_floor(jgraph, truth)
        got = built["floors"][sample]
        assert (got["hap"], got["edit"]) == (hap, ed) and ed > 0
        assert len(got["walk_s"]) == 5
        assert groundtruth.panel_floor_cached(
            None, truth, sample, panel,
            cache_path=os.path.join(d, "bench_results",
                                    ".floors_cache.json")) == (hap, ed)


def test_smoke_panel_build_twice_in_one_directory(tmp_path):
    """A second gt_build into the same directory (the smoke run again in
    one checkout) starts from an empty directory: its floors are computed
    again with every walk timed, no earlier shard is left, and phase 16a's
    check (gt_floors) passes on it."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    d = str(tmp_path / "gt")
    first = smoke.gt_build(d, 5, 30_000)
    assert smoke.gt_floors(d, first, 5) == 0
    os.makedirs(os.path.join(d, "parts"))
    stale = os.path.join(d, "parts", "subs_APD.json")
    with open(stale, "w") as f:
        f.write("{}")
    second = smoke.gt_build(d, 5, 30_000)
    assert not os.path.exists(stale)
    for sample in smoke.GT_SAMPLES:
        a, b = first["floors"][sample], second["floors"][sample]
        assert (a["hap"], a["edit"]) == (b["hap"], b["edit"])
        assert len(b["walk_s"]) == 5
    assert smoke.gt_floors(d, second, 5) == 0
