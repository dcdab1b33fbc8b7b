"""The port's sharded DP (phi_tpu_torch/parallel/sharded.py) on meshes of
2, 4 and 8 CPU shards, against phi_tpu's sharded solvers on the conftest's
8 virtual CPU devices and against the port's single-device solvers: the
same numpy tables go into both packages (carried to the port as in
tests/test_torch_solver.py). Every sharded reduction is a min or an integer
sum, so M (unpadded), end_min and the sweep count are bit-equal; the
read-hit counts of sharded_full_step are equal integers."""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from phi_tpu.parallel import sharded as jsh  # noqa: E402
from phi_tpu.solve.prep import build_solver_tables  # noqa: E402
from phi_tpu.testing import tiny_instance  # noqa: E402
from phi_tpu_torch import state  # noqa: E402
from phi_tpu_torch.anchors import join as tjoin  # noqa: E402
from phi_tpu_torch.parallel import sharded as tsh  # noqa: E402
from phi_tpu_torch.solve import dp as tdp  # noqa: E402
from phi_tpu_torch.solve import prep as tprep  # noqa: E402
from phi_tpu_torch.solve.decode import decode_path  # noqa: E402

CPU = torch.device("cpu")


def _port_tables(t):
    names = {f.name for f in dataclasses.fields(tprep.SolverTables)
             if f.compare}
    return tprep.SolverTables(**{n: getattr(t, n) for n in names})


def _port_anchors(a):
    names = {f.name for f in dataclasses.fields(tjoin.AnchorTables)
             if f.compare}
    return tjoin.AnchorTables(**{n: getattr(a, n) for n in names
                                 if n != "device_occ"})


@pytest.fixture(scope="module")
def synth():
    """A 5-walk mosaic (k 15, w 5, R 3): (graph, anchors, tables)."""
    from phi_tpu.anchors.join import build_anchor_tables, sketch_haplotypes
    from phi_tpu.eval.synth import sample_reads, synth_pangenome
    from phi_tpu.graph import tensorize
    from phi_tpu.io.gfa import encode_seq
    from phi_tpu.sketch.minimizer import sketch_read_batch
    rng = np.random.default_rng(7)
    gfa, hap_seqs = synth_pangenome(rng, length=4000, n_haps=5,
                                    indel_fraction=0.1)
    graph = tensorize(gfa)
    reads, _ = sample_reads(rng, hap_seqs, coverage=3.0, read_len=120,
                            recomb_breaks=[(1300, 3), (2700, 1)])
    codes = np.full((len(reads), 120), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = encode_seq(r)
    k, w = 15, 5
    spectrum = sketch_read_batch(codes, k, w,
                                 np.full(len(reads), 120, np.int32))
    anchors = build_anchor_tables(graph, k, sketch_haplotypes(graph, k, w),
                                  spectrum, 1.0)
    return graph, anchors, build_solver_tables(graph, anchors, 3.0)


def _jax_mesh(n):
    return jsh.make_mesh(n)


def _port_mesh(n):
    return tsh.make_mesh(n, devices=[CPU] * n)


def _esrc(t):
    return (t.esrc_h, t.esrc_p, t.esrc_target)


def _sbw(t, L):
    """The port's S, B and W (numpy) of the tables' occurrences."""
    H, P = t.state_vertex.shape
    oh, os_, osp, ow = state.occ_tensors(t.occ_hap, t.occ_start,
                                         t.occ_end - t.occ_start,
                                         t.occ_weight, CPU)
    return tuple(x.numpy() for x in tdp.build_sbw(oh, os_, osp, ow, H, P, L))


def _pad(x, mesh, value, lead=0):
    x = tsh._pad_to(x, lead, mesh.shape["hap"], value)
    return tsh._pad_to(x, lead + 1, mesh.shape["sp"], value) \
        if x.ndim > lead + 1 else x


def test_factor_mesh():
    assert tsh.factor_mesh(8) == (2, 2, 2)
    assert tsh.factor_mesh(4) == (1, 2, 2)
    assert tsh.factor_mesh(2) == (1, 1, 2)
    assert tsh.factor_mesh(1) == (1, 1, 1)
    for n in range(1, 17):
        assert tsh.factor_mesh(n) == jsh.factor_mesh(n)


def test_make_mesh_needs_visible_cards():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="a mesh of 2 devices needs 2 "
                       "visible CUDA devices; 0 visible"):
        tsh.make_mesh(2)
    mesh = tsh.make_mesh(devices=[CPU] * 8)
    assert mesh.shape == {"dp": 2, "hap": 2, "sp": 2}
    assert mesh.flat == [CPU] * 8
    with pytest.raises(ValueError, match="a mesh of 4 devices from a list "
                       "of 2"):
        tsh.make_mesh(4, devices=[CPU] * 2)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_prepare_sharded_tables_matches_jax(n):
    *_, t = tiny_instance(4, 2, 1.0)
    want = jsh.prepare_sharded_tables(t, _jax_mesh(n))
    got = tsh.prepare_sharded_tables(_port_tables(t), _port_mesh(n))
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_solve_matches(synth, n):
    """The plain fixpoint (the bracket mode's): phi_tpu's sharded_solve,
    the port's and the port's single-device solve_plain."""
    _, _, t = synth
    H, P = t.state_vertex.shape
    t = t.dense()
    jmesh, pmesh = _jax_mesh(n), _port_mesh(n)
    S, B, sv, wl = jsh.prepare_sharded_tables(t, jmesh)
    M_j, end_j, sw_j = jsh.sharded_solve(jmesh, R=t.R, n_vtx=t.n_vtx)(
        *(jnp.asarray(x) for x in (S, B, sv, wl) + _esrc(t)))
    M_t, end_t, sw_t = tsh.sharded_solve(pmesh, R=t.R, n_vtx=t.n_vtx)(
        S, B, sv, wl, *_esrc(t))
    assert sw_t == int(sw_j) and end_t == float(end_j)
    np.testing.assert_array_equal(M_t.numpy()[:H, :P],
                                  np.asarray(M_j)[:H, :P])
    eh, ep, et, sv1, wl1 = state.solver_static(t, CPU)
    M_1, ends_1, sw_1 = tdp.solve_plain(
        torch.from_numpy(t.S), torch.from_numpy(t.B), eh, ep, et, sv1, wl1,
        float(np.float32(t.R)), t.n_vtx, 256)
    assert sw_t == sw_1 and end_t == float(ends_1.min())
    np.testing.assert_array_equal(M_t.numpy()[:H, :P], M_1.numpy())


def _exact_case(t, n, L):
    """phi_tpu's sharded_solve_exact, the port's and the port's
    single-device solve_exact on the same S, B and W of L layers."""
    H, P = t.state_vertex.shape
    S, B, W = _sbw(t, L)
    jmesh, pmesh = _jax_mesh(n), _port_mesh(n)
    Sp, Bp, Wp = (_pad(S, pmesh, 0.0), _pad(B, pmesh, 0.0),
                  _pad(W, pmesh, 0.0, lead=1))
    sv, wl = _pad(t.state_vertex, pmesh, -1), _pad(t.walk_len, pmesh, 0)
    M_j, end_j, sw_j = jsh.sharded_solve_exact(
        jmesh, R=t.R, n_vtx=t.n_vtx, n_layers=L)(
        *(jnp.asarray(x) for x in (Sp, Bp, Wp, sv, wl) + _esrc(t)))
    M_t, end_t, sw_t = tsh.sharded_solve_exact(
        pmesh, R=t.R, n_vtx=t.n_vtx, n_layers=L)(
        Sp, Bp, Wp, sv, wl, *_esrc(t))
    assert sw_t == int(sw_j) and end_t == float(end_j)
    np.testing.assert_array_equal(M_t.numpy()[:H, :P],
                                  np.asarray(M_j)[:H, :P])
    eh, ep, et, sv1, wl1 = state.solver_static(t, CPU)
    M_1, ends_1, sw_1 = tdp.solve_exact(
        *(torch.from_numpy(x) for x in (S, B, W)), eh, ep, et, sv1, wl1,
        float(np.float32(t.R)), t.n_vtx, 256)
    assert sw_t == sw_1 and end_t == float(ends_1.min())
    np.testing.assert_array_equal(M_t.numpy()[:H, :P], M_1.numpy())
    return pmesh, M_t.shape


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_solve_exact_matches(synth, n):
    """The exact-credit fixpoint with the L-column halos (L <= Ps)."""
    _, _, t = synth
    assert t.n_layers >= 1
    pmesh, (_, Pp) = _exact_case(t, n, t.n_layers)
    assert t.n_layers <= Pp // pmesh.shape["sp"]


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_solve_exact_full_row_gather(n):
    """Shards narrower than L columns take the full-row gather along sp:
    the tiny instance (5 walk positions) with 8 straddle layers."""
    *_, t = tiny_instance(4, 2, 1.0)
    pmesh, (_, Pp) = _exact_case(t, n, 8)
    assert 8 > Pp // pmesh.shape["sp"]


@pytest.mark.parametrize("n", [2, 8])
def test_solve_dp_sharded_drop_in(synth, n):
    """solve_dp_sharded feeds decode_path as solve_dp does: the same bound,
    ends, sweeps and decoded path; in bracket mode (n_layers None), the
    search fixpoint's path and the optimistic fixpoint's bound, as
    solve_dp_both gives them."""
    graph, anchors, t = synth
    pt, pa = _port_tables(t), _port_anchors(anchors)
    mesh = _port_mesh(n)
    sol_s, ends_s, sw_s, lb_s = tsh.solve_dp_sharded(pt, mesh)
    sol_1, ends_1, sw_1, lb_1 = tdp.solve_dp(pt, 256, CPU)
    assert (sw_s, lb_s) == (sw_1, lb_1)
    np.testing.assert_array_equal(ends_s, ends_1)
    np.testing.assert_array_equal(sol_s.M.numpy(), sol_1.M.numpy())
    np.testing.assert_array_equal(sol_s.ent, sol_1.ent)
    res_s = decode_path(graph, pt, pa, sol_s, ends_s, sw_s, lb_s)
    res_1 = decode_path(graph, pt, pa, sol_1, ends_1, sw_1, lb_1)
    assert res_s.segments == res_1.segments
    assert res_s.true_objective == res_1.true_objective

    bt = dataclasses.replace(pt, n_layers=None).dense()
    sol_b, ends_b, _, lb_b = tsh.solve_dp_sharded(bt, mesh)
    (sol_2, ends_2), _, _, lb_2 = tdp.solve_dp_both(bt, 256, CPU)
    np.testing.assert_array_equal(sol_b.M.numpy(), sol_2.M.numpy())
    np.testing.assert_array_equal(ends_b, ends_2)
    assert lb_b == pytest.approx(lb_2, abs=1e-4)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_full_step_matches(n):
    """tests/test_sharded.py's step: the dp read sketch's hit counts equal
    phi_tpu's (the seq kernel's twin per read row here), end_min equal to
    phi_tpu's and, as there, to the single-device bound."""
    k, w, R = 4, 2, 1.0
    _, codes, lengths, spectrum, _, t = tiny_instance(k, w, R)
    jmesh, pmesh = _jax_mesh(n), _port_mesh(n)
    S, B, sv, wl = jsh.prepare_sharded_tables(t, jmesh)
    nd = jmesh.shape["dp"]
    n_pad = -(-codes.shape[0] // nd) * nd
    codes_p = np.full((n_pad, codes.shape[1]), 4, np.uint8)
    codes_p[:codes.shape[0]] = codes
    lengths_p = np.zeros(n_pad, np.int32)
    lengths_p[:len(lengths)] = lengths
    args = (codes_p, lengths_p, spectrum[0], spectrum[1], S, B, sv, wl) \
        + _esrc(t)
    hits_j, M_j, end_j = jsh.sharded_full_step(
        jmesh, k=k, w=w, R=R, n_vtx=t.n_vtx, n_sweeps=8)(
        *(jnp.asarray(x) for x in args))
    hits_t, M_t, end_t = tsh.sharded_full_step(
        pmesh, k=k, w=w, R=R, n_vtx=t.n_vtx, n_sweeps=8)(*args)
    np.testing.assert_array_equal(hits_t.numpy(), np.asarray(hits_j))
    assert (hits_t > 0).all()
    assert end_t == float(end_j)
    np.testing.assert_array_equal(M_t.numpy(), np.asarray(M_j))
    _, ends_1, _, _ = tdp.solve_dp(_port_tables(t), 256, CPU)
    assert end_t == pytest.approx(float(ends_1.min()), abs=1e-4)
