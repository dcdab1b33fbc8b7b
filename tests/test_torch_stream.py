"""Streamed W: the port's solve_exact over a StreamedW (each straddle layer
rebuilt from the occurrence columns in every sweep) against phi_tpu's
_solve_exact_stream and against the port's solve over the materialized
stack, on tables made from a seed with numpy. At unit weights every f32
scatter sum is a small integer, so M, ends and the sweep count are
bit-equal; at fractional weights the port's two solves share their
summation order but phi_tpu's does not (tolerance 1e-3, as
test_torch_solver.py::test_exact_solve_fractional_weights). End to end,
run_pipeline under PHI_TPU_STREAM_W=1 against phi_tpu's pipeline under
PHI_TPU_STREAM_W=1 PHI_TPU_FORCE_DEVICE_SOLVE=1; and the rule that picks
streaming: forced either way on any device, never unforced on the CPU."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from phi_tpu.solve import dp as jdp  # noqa: E402
from phi_tpu.config import Options as JaxOptions  # noqa: E402
from phi_tpu_torch.config import Options  # noqa: E402
from phi_tpu_torch.solve import dp as tdp  # noqa: E402
from tests.test_torch_pipeline import _mosaic, _paralog  # noqa: E402

R_PEN = 3.0


def _tables(L: int, seed: int, unit: bool):
    """A random exact-mode instance: H walks of P lanes (ragged lengths,
    -1 pads) over a chain of bubbles (lane p of a walk visits vertex
    2p or 2p + 1), switch sources into the next position's vertices, and
    occurrences whose spans need at most L straddle layers
    (span <= L + 1)."""
    rng = np.random.default_rng(seed)
    H, P, E, N = 5, 400, 900, 1500
    V = 2 * P
    walk_len = rng.integers(P // 2, P + 1, H).astype(np.int32)
    walk_len[0] = P
    sv = (2 * np.arange(P)[None, :] + rng.integers(0, 2, (H, P))
          ).astype(np.int32)
    sv[np.arange(P)[None, :] >= walk_len[:, None]] = -1
    eh = rng.integers(0, H, E).astype(np.int32)
    ep = (rng.random(E) * (walk_len[eh] - 1)).astype(np.int32)
    et = (2 * (ep + 1) + rng.integers(0, 2, E)).astype(np.int32)
    oh = rng.integers(0, H, N).astype(np.int32)
    span = rng.integers(1, L + 2, N).astype(np.int32)
    os_ = (rng.random(N) * (walk_len[oh] - span)).astype(np.int32)
    ow = np.ones(N, np.float32) if unit else \
        rng.random(N).astype(np.float32)
    return dict(H=H, P=P, V=V, sv=sv, wl=walk_len, eh=eh, ep=ep, et=et,
                oh=oh, os=os_, span=span, ow=ow, L=L)


def _jax_stream(t):
    S, B, _ = jdp._build_sbw_jit(
        jnp.asarray(t["oh"]), jnp.asarray(t["os"]), jnp.asarray(t["span"]),
        jnp.asarray(t["ow"]), H=t["H"], P=t["P"], L=0)
    M, ends, sweeps = jdp._solve_exact_stream(
        S, B, jnp.asarray(t["oh"]), jnp.asarray(t["os"]),
        jnp.asarray(t["span"]), jnp.asarray(t["ow"]), jnp.asarray(t["eh"]),
        jnp.asarray(t["ep"]), jnp.asarray(t["et"]), jnp.asarray(t["sv"]),
        jnp.asarray(t["wl"]), jnp.float32(R_PEN), n_vtx=t["V"],
        max_sweeps=256, L=t["L"])
    return np.asarray(M), np.asarray(ends), int(sweeps)


def _port(t, streamed: bool):
    def i64(a):
        return torch.from_numpy(np.asarray(a, np.int64))
    oh, os_, span = i64(t["oh"]), i64(t["os"]), i64(t["span"])
    ow = torch.from_numpy(t["ow"])
    H, P, L = t["H"], t["P"], t["L"]
    S, B, W = tdp.build_sbw(oh, os_, span, ow, H, P, 0 if streamed else L)
    if streamed:
        W = tdp.StreamedW(oh, os_, span, ow, H, P, L)
    M, ends, sweeps = tdp.solve_exact(
        S, B, W, i64(t["eh"]), i64(t["ep"]), i64(t["et"]), i64(t["sv"]),
        i64(t["wl"]), R_PEN, t["V"], 256)
    return M.numpy(), ends.numpy(), sweeps


@pytest.mark.parametrize("L", [0, 1, 4, 16])
def test_streamed_solve_bit_equal_unit_weights(L):
    t = _tables(L, seed=L, unit=True)
    got = _port(t, streamed=True)
    assert 2 <= got[2] < 256 and np.isfinite(got[1]).all()
    for want in (_jax_stream(t), _port(t, streamed=False)):
        assert got[2] == want[2]
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("L", [1, 16])
def test_streamed_solve_fractional_weights(L):
    t = _tables(L, seed=100 + L, unit=False)
    got = _port(t, streamed=True)
    mat = _port(t, streamed=False)
    assert got[2] == mat[2]
    assert np.array_equal(got[0], mat[0]) and np.array_equal(got[1], mat[1])
    M_j, ends_j, _ = _jax_stream(t)
    fin = np.isfinite(M_j)
    assert np.array_equal(fin, np.isfinite(got[0]))
    np.testing.assert_allclose(got[0][fin], M_j[fin], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[1], ends_j, atol=1e-3, rtol=0)


def test_streamed_w_layers_equal_the_stack():
    t = _tables(16, seed=5, unit=False)
    args = [torch.from_numpy(np.asarray(t[n], np.int64))
            for n in ("oh", "os", "span")] + [torch.from_numpy(t["ow"])]
    _, _, W = tdp.build_sbw(*args, t["H"], t["P"], 16)
    sw = tdp.StreamedW(*args, t["H"], t["P"], 16)
    assert sw.shape == tuple(W.shape)
    for j in range(16):
        assert torch.equal(sw[j], W[j])


@pytest.mark.parametrize("case,kw", [
    (_mosaic, dict(recombination=5.0)),
    (lambda p: _paralog(p, seed=2, mult=4), dict(k=8, w=3,
                                                 recombination=100.0)),
], ids=["mosaic", "paralog"])
def test_pipeline_streamed_matches_jax(tmp_path, monkeypatch, case, kw):
    from phi_tpu.pipeline import run_pipeline as jax_run
    from phi_tpu_torch.pipeline import run_pipeline
    gfa_path, reads_path = case(tmp_path)
    monkeypatch.setenv("PHI_TPU_STREAM_W", "1")
    monkeypatch.setenv("PHI_TPU_FORCE_DEVICE_SOLVE", "1")
    want = jax_run(gfa_path, reads_path, str(tmp_path / "jax.fa"),
                   JaxOptions(**kw))
    built = []

    class Counted(tdp.StreamedW):
        def __init__(self, *a):
            built.append(a[-1])
            super().__init__(*a)

    monkeypatch.setattr(tdp, "StreamedW", Counted)
    got = run_pipeline(gfa_path, reads_path, str(tmp_path / "torch.fa"),
                       Options(**kw), device="cpu")
    assert built and max(built) > 0   # build_sbw builds L = 0 ones too
    with open(tmp_path / "jax.fa", "rb") as a, \
            open(tmp_path / "torch.fa", "rb") as b:
        assert a.read() == b.read()
    assert got.recombination_count == want.recombination_count
    assert got.report_segments == want.report_segments
    assert got.decode.dp_objective == pytest.approx(
        want.decode.dp_objective, abs=1e-3)
    assert got.decode.true_objective == pytest.approx(
        want.decode.true_objective, abs=1e-3)


def test_stream_rule_forced_and_never_on_the_cpu(monkeypatch):
    big = (49, 8_400_000, 16, 10 ** 9)   # 26 GB of W: a 232-walk chr1 cut
    cpu = torch.device("cpu")
    monkeypatch.delenv("PHI_TPU_STREAM_W", raising=False)
    monkeypatch.delenv("PHI_TPU_STREAM_W_GB", raising=False)
    assert not tdp.stream_w(*big, cpu)
    monkeypatch.setenv("PHI_TPU_STREAM_W_GB", "0.001")
    assert not tdp.stream_w(*big, cpu)
    monkeypatch.setenv("PHI_TPU_STREAM_W", "1")
    assert tdp.stream_w(4, 10, 1, 1, cpu)
    monkeypatch.setenv("PHI_TPU_STREAM_W", "0")
    assert not tdp.stream_w(*big, torch.device("cuda"))
