"""The mesh's measured collectives: `parallel.sharded.count_collectives`
and `eval.mesh_trace` (the port's counterpart of phi_tpu/eval/mesh_trace.py)
on CPU shards, against a closed form and against the JAX module's HLO on
the conftest's 8 virtual CPU devices.

The closed form the port's code has, for one executed exact-credit sweep
with L <= Ps over G = n_hap x n_sp shards (counts summed over the shards;
per device is that over G):
  all-reduce          the [n_vtx] f32 entry minimum, ONE reduction over
                      hap x sp (the JAX program runs two, over sp then
                      hap): G calls, 4 n_vtx G bytes out, 2 (G - 1) 4 n_vtx
                      moved (onto the first shard and back);
  all-gather          the [Hs] f32 sp totals, one gather per sp row:
                      G calls, G n_sp 4 Hs out, G (n_sp - 1) 4 Hs moved;
  collective-permute  two [Hs, L] f32 halos per sp row: 2 G calls,
                      2 G 4 Hs L out, 2 n_hap (n_sp - 1) 4 Hs L moved;
and each convergence vote, one all-reduce of G 1-byte bools read on the
host: G calls, G bytes out, G - 1 moved, one host sync. end_min is one
all-reduce of G f32 scalars (G calls, 4 G out, 2 (G - 1) 4 moved) and one
host sync; setup runs no collective.

The relation to the JAX module: its compiled program traces the sweep
three times (M1 = sweep(M0), the while loop's initial carry sweep(M1), the
loop body), so per kind its instructions and output bytes are three
times one port sweep's per device, with each hap x sp reduction of the
port as two instructions of the same shape; plus the vote (two s32
all-reduces, where the port reduces one bool) and end_min (two f32
all-reduces, where the port runs one). The module's all-reduce total is
thus three executed sweeps' entry minima, not one."""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from phi_tpu.eval.mesh_trace import collective_bytes_from_hlo  # noqa: E402
from phi_tpu.parallel import sharded as jsh  # noqa: E402
from phi_tpu_torch.eval import mesh_trace  # noqa: E402
from phi_tpu_torch.eval import scale as tscale  # noqa: E402
from phi_tpu_torch.parallel import sharded as tsh  # noqa: E402
from phi_tpu_torch.sketch import kernels  # noqa: E402

from test_torch_sharded import (_esrc, _pad, _port_mesh,  # noqa: E402
                                _port_tables, _sbw, synth)  # noqa: F401

KINDS = tsh.KINDS


def _exact_inputs(t, mesh):
    """The padded (S, B, W, state_vertex, walk_len, esrc tables) of the
    synth tables on `mesh` (numpy), as tests/test_torch_sharded.py builds
    them."""
    L = t.n_layers
    S, B, W = _sbw(t, L)
    return ((_pad(S, mesh, 0.0), _pad(B, mesh, 0.0), _pad(W, mesh, 0.0,
                                                          lead=1),
             _pad(t.state_vertex, mesh, -1), _pad(t.walk_len, mesh, 0))
            + _esrc(t))


def _counted(t, mesh):
    """The port's sharded exact solve on the synth tables, counted:
    ((M, end_min, sweeps), CollectiveCount)."""
    solve = tsh.sharded_solve_exact(mesh, R=t.R, n_vtx=t.n_vtx,
                                    n_layers=t.n_layers)
    with tsh.count_collectives() as count:
        out = solve(*_exact_inputs(t, mesh))
    return out, count


def _rec(calls, out, moved, syncs=0):
    return {"calls": dict(zip(KINDS, calls)),
            "out_bytes": dict(zip(KINDS, out)),
            "moved_bytes": dict(zip(KINDS, moved)), "host_syncs": syncs}


def _closed(t, mesh):
    """The docstring's closed form, summed over the shards: (sweep, vote,
    end) records."""
    nh, ns = mesh.shape["hap"], mesh.shape["sp"]
    G, L = nh * ns, t.n_layers
    Hs = -(-t.state_vertex.shape[0] // nh)
    e, tot, halo = 4 * t.n_vtx, 4 * Hs, 4 * Hs * L
    sweep = _rec((G, G, 2 * G), (G * e, G * ns * tot, 2 * G * halo),
                 (2 * (G - 1) * e, G * (ns - 1) * tot,
                  2 * nh * (ns - 1) * halo))
    vote = _rec((G, 0, 0), (G, 0, 0), (G - 1, 0, 0), syncs=1)
    end = _rec((G, 0, 0), (4 * G, 0, 0), (8 * (G - 1), 0, 0), syncs=1)
    return sweep, vote, end


@pytest.mark.parametrize("n", [2, 4, 8])
def test_per_sweep_counts_equal_the_closed_form(synth, n):
    _, _, t = synth
    mesh = _port_mesh(n)
    (_, _, sweeps), count = _counted(t, mesh)
    sweep, vote, end = _closed(t, mesh)
    names = [name for name, _ in count.scopes]
    assert names == (["setup", "sweep", "sweep"]
                     + ["vote", "sweep"] * (sweeps - 2) + ["vote", "end"])
    assert count.records("setup") == [_rec((0,) * 3, (0,) * 3, (0,) * 3)]
    assert count.records("sweep") == [sweep] * sweeps
    assert count.records("vote") == [vote] * (sweeps - 1)
    assert count.records("end") == [end]

    G = mesh.shape["hap"] * mesh.shape["sp"]
    rec = mesh_trace.summarize(count, G)
    Hs = -(-t.state_vertex.shape[0] // mesh.shape["hap"])
    form = mesh_trace.sweep_closed_form(t.n_vtx, Hs, t.n_layers,
                                        mesh.shape["hap"], mesh.shape["sp"])
    assert rec["per_sweep"] == form
    for f in ("calls", "out_bytes", "moved_bytes"):
        assert form[f] == {k: (sweep[f][k] + vote[f][k]) / G for k in KINDS}
    assert rec["uniform"] and rec["host_syncs_per_sweep"] == 1
    assert (rec["sweeps_counted"], rec["votes_counted"]) == (sweeps,
                                                              sweeps - 1)


def test_full_row_gather_counts():
    """Shards narrower than L columns gather the full row of A along sp
    (one tiled all-gather a sweep, no halo): per device n_sp [Hs, Ps] f32
    out, and n_sp - 1 of them moved."""
    from phi_tpu.testing import tiny_instance
    *_, t = tiny_instance(4, 2, 1.0)
    t = _port_tables(t)
    t.n_layers = 8
    mesh = _port_mesh(8)
    (M, _, sweeps), count = _counted(t, mesh)
    nh, ns = mesh.shape["hap"], mesh.shape["sp"]
    G, (Hp, Pp) = nh * ns, M.shape
    part = 4 * (Hp // nh) * (Pp // ns)
    assert 8 > Pp // ns
    for rec in count.records("sweep"):
        assert rec["calls"] == {"all-reduce": G, "all-gather": G,
                                "collective-permute": 0}
        assert rec["out_bytes"]["all-gather"] == G * ns * part
        assert rec["moved_bytes"]["all-gather"] == G * (ns - 1) * part
    assert len(count.records("sweep")) == sweeps


def test_jax_module_holds_three_sweeps(synth):
    """The JAX module's HLO on 8 devices against the port's counts on 8
    CPU shards of the same instance (the relation in the docstring), and
    the sharded M, end_min and sweeps equal to phi_tpu's."""
    _, _, t = synth
    H, P = t.state_vertex.shape
    pmesh, jmesh = _port_mesh(8), jsh.make_mesh(8)
    args = _exact_inputs(t, pmesh)
    jfn = jsh.sharded_solve_exact(jmesh, R=t.R, n_vtx=t.n_vtx,
                                  n_layers=t.n_layers)
    jargs = tuple(jnp.asarray(x) for x in args)
    hlo = collective_bytes_from_hlo(jfn.lower(*jargs).compile().as_text())
    M_j, end_j, sw_j = jfn(*jargs)
    (M_t, end_t, sw_t), count = _counted(t, pmesh)
    assert sw_t == int(sw_j) and end_t == float(end_j)
    np.testing.assert_array_equal(M_t.numpy()[:H, :P],
                                  np.asarray(M_j)[:H, :P])

    G = pmesh.shape["hap"] * pmesh.shape["sp"]

    def per_device(name, field):
        rec = count.records(name)[0][field]
        return {k: v // G for k, v in rec.items()}
    sweep_c, vote_c, end_c = (per_device(n, "calls")
                              for n in ("sweep", "vote", "end"))
    sweep_b, end_b = (per_device(n, "out_bytes") for n in ("sweep", "end"))
    got_kinds = {k for k in KINDS if sweep_c[k]}
    assert set(hlo["instructions"]) == got_kinds
    for kind in ("all-gather", "collective-permute"):
        assert hlo["instructions"][kind] == 3 * sweep_c[kind]
        assert hlo["bytes_per_execution"][kind] == 3 * sweep_b[kind]
    ar = "all-reduce"
    assert hlo["instructions"][ar] == 2 * (3 * sweep_c[ar] + vote_c[ar]
                                           + end_c[ar])
    assert hlo["bytes_per_execution"][ar] == (
        2 * (3 * sweep_b[ar] + end_b[ar]) + 2 * 4 * vote_c[ar])
    assert sweep_b[ar] == 4 * t.n_vtx


def test_counter_changes_no_result(synth):
    """With the counter off the solve is bit-equal to a counted one, and
    no count records anything; a nested count restores the outer one."""
    _, _, t = synth
    mesh = _port_mesh(4)
    (M1, e1, s1), count = _counted(t, mesh)
    scopes = json.dumps(count.scopes)
    solve = tsh.sharded_solve_exact(mesh, R=t.R, n_vtx=t.n_vtx,
                                    n_layers=t.n_layers)
    M0, e0, s0 = solve(*_exact_inputs(t, mesh))
    assert torch.equal(M0, M1) and e0 == e1 and s0 == s1
    assert tsh._COUNT is None and json.dumps(count.scopes) == scopes
    with tsh.count_collectives() as outer:
        with tsh.count_collectives() as inner:
            assert tsh._COUNT is inner
        assert tsh._COUNT is outer and not outer.scopes
    assert tsh._COUNT is None


@pytest.fixture(scope="module")
def tiny_cache(tmp_path_factory):
    """eval/scale's instance cache in a temporary directory, and join_many
    at a small row geometry (the twin's work scales with the rows' lanes;
    results do not depend on it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tscale, "CACHE_DIR",
                   str(tmp_path_factory.mktemp("scale")))
        mp.setattr(kernels, "SUPER_BLOCKS", 2)
        yield


KEYS = {"data", "n_devices", "n_haps", "length", "coverage",
        "byte_identical_mesh_vs_single", "wall_single_s", "wall_mesh_s",
        "solve_wall_mesh_s", "n_sweeps", "per_sweep_mb_per_device",
        "device", "collectives", "solve_wall_single_s", "note"}


def test_run_on_cpu_shards(tiny_cache):
    rec = mesh_trace.run(4, 20_000, 2.0, 0, device="cpu", shards=4)
    assert KEYS <= set(rec)
    assert rec["byte_identical_mesh_vs_single"] is True
    assert rec["solve_bit_equal_mesh_vs_single"] is True
    assert rec["solve_bit_equal_counted_vs_not"] is True
    assert rec["n_devices"] == 4 and rec["device"] == "cpu"
    assert rec["mesh"] == {"dp": 1, "hap": 2, "sp": 2, "devices": ["cpu"]}
    comm = rec["collectives"]
    assert comm["uniform"] and comm["shards"] == 4
    assert comm["sweeps_counted"] == rec["n_sweeps"] >= 2
    assert comm["per_sweep"] == rec["closed_form_per_sweep"] is not None
    assert comm["host_syncs_per_sweep"] == 1
    assert rec["per_sweep_mb_per_device"] == sum(
        comm["per_sweep"]["out_bytes"].values()) / 1e6
    for key in ("wall_single_s", "wall_mesh_s", "solve_wall_mesh_s",
                "solve_wall_single_s"):
        assert rec[key] > 0
    walls = comm["wall_s"]
    assert set(walls) == {"setup", "sweeps", "votes", "end"}
    assert min(walls.values()) >= 0
    assert sum(walls.values()) <= rec["solve_wall_mesh_s"]


def test_main_writes_the_record(tiny_cache, tmp_path, capsys):
    out = tmp_path / "rec" / "comm"
    assert mesh_trace.main(["--haps", "4", "--length", "20000",
                            "--coverage", "2", "--skip-e2e", "--device",
                            "cpu", "--out", str(out)]) == 0
    rec = json.loads((tmp_path / "rec" / "comm.json").read_text())
    assert rec["n_devices"] == 2 and rec["wall_mesh_s"] is None
    assert rec["byte_identical_mesh_vs_single"] is None
    assert rec["mesh"]["sp"] == 2
    assert json.loads(capsys.readouterr().out) == rec


def test_cuda_without_a_card_raises(tmp_path, capfd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_trace.run(4, 20_000, 2.0, 0)
    out = tmp_path / "comm"
    assert mesh_trace.main(["--haps", "4", "--length", "20000",
                            "--out", str(out)]) == 1
    assert "[E::main]" in capfd.readouterr().err
    assert not (tmp_path / "comm.json").exists()
