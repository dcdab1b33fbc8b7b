"""Exact-credit DP parity: the same numpy SolverTables, carried to torch by
state.py, through the port's build_sbw + solve_exact and through phi_tpu's
_build_sbw_jit + _solve_exact_jit. With all-1.0 weights every f32 sum is a
small integer, so M, ends and the sweep count are bit-equal; with the
fractional weights of a Lagrangian round the summation order differs
(tolerance 1e-3) and the decoded path must be the same."""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from phi_tpu.anchors.join import build_anchor_tables, sketch_haplotypes  # noqa: E402
from phi_tpu.graph import tensorize  # noqa: E402
from phi_tpu.io.gfa import encode_seq, read_gfa  # noqa: E402
from phi_tpu.sketch.minimizer import sketch_read_batch  # noqa: E402
from phi_tpu.solve import dp as jdp  # noqa: E402
from phi_tpu.solve.prep import build_solver_tables  # noqa: E402
from phi_tpu_torch import state  # noqa: E402
from phi_tpu_torch.anchors import join as tjoin  # noqa: E402
from phi_tpu_torch.solve import dp as tdp  # noqa: E402
from phi_tpu_torch.solve import prep as tprep  # noqa: E402
from phi_tpu_torch.solve.decode import decode_path  # noqa: E402

R_PEN = 3.0


@pytest.fixture(scope="module")
def instance(tmp_path_factory):
    from phi_tpu.eval.synth import sample_reads, synth_pangenome
    from phi_tpu.io.gfa import write_gfa
    rng = np.random.default_rng(7)
    gfa_path = str(tmp_path_factory.mktemp("solver") / "g.gfa")
    gfa_data, hap_seqs = synth_pangenome(rng, length=8000, n_haps=5,
                                         indel_fraction=0.1)
    write_gfa(gfa_data, path=gfa_path)
    reads, _ = sample_reads(rng, hap_seqs, coverage=3.0, read_len=120,
                            error_rate=0.0,
                            recomb_breaks=[(2500, 3), (5500, 1)])
    graph = tensorize(read_gfa(gfa_path))
    k, w = 15, 5
    rc = np.full((len(reads), 120), 4, np.uint8)
    for i, r in enumerate(reads):
        rc[i, :len(r)] = encode_seq(r)
    spectrum = sketch_read_batch(rc, k, w,
                                 np.full(len(reads), 120, np.int32))
    anchors = build_anchor_tables(graph, k, sketch_haplotypes(graph, k, w),
                                  spectrum, 1.0)
    return graph, anchors


def _jax_solve(t, max_sweeps=256):
    H, P = t.state_vertex.shape
    span = (t.occ_end - t.occ_start).astype(np.int32)
    S, B, W = jdp._build_sbw_jit(
        jnp.asarray(t.occ_hap), jnp.asarray(t.occ_start), jnp.asarray(span),
        jnp.asarray(t.occ_weight), H=H, P=P, L=t.n_layers)
    M, ends, sweeps, _ = jdp._solve_exact_jit(
        S, B, W, jnp.asarray(t.esrc_h), jnp.asarray(t.esrc_p),
        jnp.asarray(t.esrc_target), jnp.asarray(t.state_vertex),
        jnp.asarray(t.walk_len), jnp.float32(t.R), n_vtx=t.n_vtx,
        max_sweeps=max_sweeps)
    return np.asarray(M), np.asarray(ends), int(sweeps)


def _torch_solve(t, max_sweeps=256):
    H, P = t.state_vertex.shape
    oh, os_, osp, ow = state.occ_tensors(t.occ_hap, t.occ_start,
                                         t.occ_end - t.occ_start,
                                         t.occ_weight, "cpu")
    S, B, W = tdp.build_sbw(oh, os_, osp, ow, H, P, t.n_layers)
    eh, ep, et, sv, wl = state.solver_static(t, "cpu")
    M, ends, sweeps = tdp.solve_exact(S, B, W, eh, ep, et, sv, wl, t.R,
                                      t.n_vtx, max_sweeps)
    return M.numpy(), ends.numpy(), sweeps


def _port_tables(t):
    """The port's SolverTables over the same numpy arrays."""
    names = {f.name for f in dataclasses.fields(tprep.SolverTables)}
    return tprep.SolverTables(**{n: getattr(t, n) for n in names})


def _port_anchors(a):
    names = {f.name for f in dataclasses.fields(tjoin.AnchorTables)}
    return tjoin.AnchorTables(**{n: getattr(a, n) for n in names
                                 if n != "device_occ"})


def test_sbw_matches_credit_arrays(instance):
    graph, anchors = instance
    t = build_solver_tables(graph, anchors, R_PEN)
    H, P = t.state_vertex.shape
    oh, os_, osp, ow = state.occ_tensors(t.occ_hap, t.occ_start,
                                         t.occ_end - t.occ_start,
                                         t.occ_weight, "cpu")
    S, B, _ = tdp.build_sbw(oh, os_, osp, ow, H, P, 0)
    S_ref, B_ref = tjoin.credit_arrays(graph, _port_anchors(anchors))
    assert np.array_equal(S.numpy(), S_ref)
    assert np.array_equal(B.numpy(), B_ref)


def test_exact_solve_bit_equal_unit_weights(instance):
    graph, anchors = instance
    t = build_solver_tables(graph, anchors, R_PEN)
    assert t.n_layers > 0 and len(t.occ_hap) > 0
    M_j, ends_j, sw_j = _jax_solve(t)
    M_t, ends_t, sw_t = _torch_solve(t)
    assert sw_t == sw_j
    assert np.array_equal(M_t, M_j)
    assert np.array_equal(ends_t, ends_j)


def test_exact_solve_fractional_weights(instance, monkeypatch):
    graph, anchors = instance
    rng = np.random.default_rng(3)
    mu = rng.random(int(anchors.occ_kmer.max()) + 1).astype(np.float32)
    anchors_w = dataclasses.replace(anchors, occ_weight=mu[anchors.occ_kmer])
    t = build_solver_tables(graph, anchors_w, R_PEN)
    M_j, ends_j, _ = _jax_solve(t)
    M_t, ends_t, _ = _torch_solve(t)
    fin = np.isfinite(M_j)
    assert np.array_equal(fin, np.isfinite(M_t))
    np.testing.assert_allclose(M_t[fin], M_j[fin], atol=1e-3, rtol=0)
    np.testing.assert_allclose(ends_t, ends_j, atol=1e-3, rtol=0)

    # decoded path: phi_tpu's device solve + decode vs the port's
    monkeypatch.setenv("PHI_TPU_FORCE_DEVICE_SOLVE", "1")
    from phi_tpu.solve.decode import decode_path as jax_decode
    want = jax_decode(graph, t, anchors_w, *jdp.solve_dp(t))
    pt = _port_tables(t)
    got = decode_path(graph, pt, _port_anchors(anchors_w),
                      *tdp.solve_dp(pt, 256, torch.device("cpu")))
    assert got.segments == want.segments
    assert want.n_switches > 0
    assert got.n_switches == want.n_switches
    assert got.true_objective == pytest.approx(want.true_objective, abs=1e-3)
    assert got.dp_objective == pytest.approx(want.dp_objective, abs=1e-3)
    assert got.solver_device == "cpu"
