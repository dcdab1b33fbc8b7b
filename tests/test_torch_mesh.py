"""The pipeline on a mesh (`run_pipeline` with opt.mesh_devices, `--mesh N`)
on 2, 4 and 8 CPU shards, against phi_tpu's run_pipeline with
mesh_devices=N on the conftest's virtual CPU devices and against the
port's single-device run: a byte-identical FASTA and report, an equal
bound and objective. Cases: the default flags, a walk holding N, the
checkpoint with --mesh 2 (index arrays equal to phi_tpu's), a low-R
instance whose gap climbs the Lagrangian ladder (every re-solve sharded),
the CLI with --device cpu --mesh 4, --device cuda --mesh 2 without a card,
and the throughput runner's sketch@2dev record."""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from phi_tpu.config import Options as JaxOptions  # noqa: E402
from phi_tpu_torch import pipeline  # noqa: E402
from phi_tpu_torch.config import Options  # noqa: E402
from phi_tpu_torch.sketch import kernels  # noqa: E402

from test_torch_checkpoint import _arrays, _n_walk, _read  # noqa: E402
from test_torch_debug import _mosaic  # noqa: E402
from test_torch_pipeline import _refinement  # noqa: E402


@pytest.fixture
def jax_run(monkeypatch):
    """phi_tpu's run_pipeline with its device solve."""
    monkeypatch.setenv("PHI_TPU_FORCE_DEVICE_SOLVE", "1")
    from phi_tpu.pipeline import run_pipeline
    return run_pipeline


@pytest.fixture(autouse=True)
def small_rows(monkeypatch):
    """join_many at a small row geometry (the twin's work scales with the
    rows' lanes): results do not depend on it."""
    monkeypatch.setattr(kernels, "SUPER_BLOCKS", 2)


@pytest.fixture
def spy(monkeypatch):
    """Counts of the mesh's solves and of join_many calls given devices."""
    n = {"solve": 0, "join_devices": []}
    solve, join = pipeline.solve_dp_sharded, pipeline.join_many

    def solve_spy(tables, mesh, *a):
        n["solve"] += 1
        assert all(d.type == "cpu" for d in mesh.flat)
        return solve(tables, mesh, *a)

    def join_spy(*a, devices=None, **kw):
        n["join_devices"].append(devices)
        return join(*a, devices=devices, **kw)
    monkeypatch.setattr(pipeline, "solve_dp_sharded", solve_spy)
    monkeypatch.setattr(pipeline, "join_many", join_spy)
    return n


def _same(got, want, got_fa, want_fa):
    assert _read(got_fa) == _read(want_fa)
    assert got.report_segments == want.report_segments
    assert got.recombination_count == want.recombination_count
    assert got.decode.dp_objective == want.decode.dp_objective
    assert got.decode.true_objective == want.decode.true_objective


def _both(tmp_path, jax_run, gfa, reads, n, **kw):
    """(port run, its FASTA, phi_tpu's run, its FASTA) on a mesh of n."""
    jfa, tfa = tmp_path / f"jax{n}.fa", tmp_path / f"port{n}.fa"
    want = jax_run(gfa, reads, str(jfa), JaxOptions(mesh_devices=n, **kw))
    got = pipeline.run_pipeline(gfa, reads, str(tfa),
                                Options(mesh_devices=n, **kw), device="cpu")
    return got, tfa, want, jfa


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_pipeline_matches(tmp_path, jax_run, spy, n):
    gfa, reads = _mosaic(tmp_path)
    kw = dict(k=11, w=5, recombination=5.0)
    got, tfa, want, jfa = _both(tmp_path, jax_run, gfa, reads, n, **kw)
    _same(got, want, tfa, jfa)
    assert spy["solve"] >= 1 and len(spy["join_devices"][0]) == n
    one = pipeline.run_pipeline(gfa, reads, str(tmp_path / "one.fa"),
                                Options(**kw), device="cpu")
    _same(got, one, tfa, tmp_path / "one.fa")
    assert got.anchors.device_occ is None and got.hits is not None


def test_mesh_walk_with_n(tmp_path, jax_run, spy):
    gfa, reads = _n_walk(tmp_path)
    got, tfa, want, jfa = _both(tmp_path, jax_run, gfa, reads, 2, k=5, w=3)
    _same(got, want, tfa, jfa)
    # the walk holding N was joined on the host: the same hits either way
    for a, b in zip(got.hits, pipeline.run_pipeline(
            gfa, reads, None, Options(k=5, w=3, save_index=str(
                tmp_path / "i.npz")), device="cpu").hits):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])


def test_mesh_save_and_load_index(tmp_path, jax_run, spy):
    gfa, reads = _mosaic(tmp_path)
    kw = dict(k=11, w=5, recombination=5.0)
    jidx, tidx = tmp_path / "j.npz", tmp_path / "t.npz"
    got, tfa, want, jfa = _both(tmp_path, jax_run, gfa, reads, 2,
                                save_index=str(tidx), **kw)
    jax_run(gfa, reads, str(tmp_path / "jsave.fa"),
            JaxOptions(mesh_devices=2, save_index=str(jidx), **kw))
    assert _read(jfa) == _read(tmp_path / "jsave.fa")
    _same(got, want, tfa, jfa)
    a, b = _arrays(jidx), _arrays(tidx)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    kw.update(recombination=2.0)
    lfa = tmp_path / "load.fa"
    spy["join_devices"].clear()
    loaded = pipeline.run_pipeline(
        gfa, reads, str(lfa), Options(mesh_devices=2, load_index=str(tidx),
                                      **kw), device="cpu")
    assert spy["join_devices"] == []
    jload = jax_run(gfa, reads, str(tmp_path / "jload.fa"),
                    JaxOptions(mesh_devices=2, load_index=str(jidx), **kw))
    _same(loaded, jload, lfa, tmp_path / "jload.fa")


def test_mesh_ladder_resolves_on_the_mesh(tmp_path, jax_run, spy):
    """The open-gap instance of tests/test_torch_pipeline.py: the
    Lagrangian rounds and the exact enumeration run, each re-solve
    sharded over the mesh."""
    gfa, reads = _refinement(tmp_path, seed=19)
    kw = dict(k=4, w=2, recombination=1.0, lagrangian_rounds=6)
    got, tfa, want, jfa = _both(tmp_path, jax_run, gfa, reads, 4, **kw)
    _same(got, want, tfa, jfa)
    assert spy["solve"] > 1


def test_cli_mesh_on_cpu(tmp_path, capfd, spy):
    from phi_tpu_torch.cli import main
    gfa, reads = _mosaic(tmp_path)
    flags = ["-k", "11", "-w", "5", "-R", "5", "--device", "cpu"]
    assert main(["-g", gfa, "-r", reads, "-o", str(tmp_path / "m.fa"),
                 "--mesh", "4"] + flags) == 0
    assert spy["solve"] >= 1 and len(spy["join_devices"][0]) == 4
    assert main(["-g", gfa, "-r", reads, "-o", str(tmp_path / "o.fa")]
                + flags) == 0
    assert _read(tmp_path / "m.fa") == _read(tmp_path / "o.fa")
    capfd.readouterr()


def test_cli_cuda_mesh_without_card(tmp_path, capfd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from phi_tpu_torch.cli import main
    gfa, reads = _mosaic(tmp_path)
    out = tmp_path / "o.fa"
    assert main(["-g", gfa, "-r", reads, "-o", str(out), "--device", "cuda",
                 "--mesh", "2"]) == 1
    assert "[E::main]" in capfd.readouterr().err
    assert not out.exists()
    with pytest.raises(ValueError, match="needs 2 visible CUDA devices; "
                       "0 visible"):
        pipeline.mesh_for(2, "cuda")


def test_throughput_mesh_record(capsys):
    from phi_tpu_torch.eval import throughput
    calls = kernels.sketch_seq.launches
    assert throughput.main(["--mbases", "0.05", "--repeats", "1", "--mesh",
                            "2", "--device", "cpu"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["metric"] for r in rows] == ["sketch", "join", "sketch@2dev"]
    assert rows[2]["spectrum"] == rows[0]["spectrum"] > 0
    assert rows[2]["backend"] == "cpu"
    assert kernels.sketch_seq.launches == calls  # no card: the twin ran
