"""Card tests of the port: the rows3, rows3w, rows2, rows and seq CUDA
kernels against their plain twins on the same CUDA tensors, at the main
path's shape and on inputs at the tiled design's edges (for seq, N at
lane 0, at tile and block edges, in the last window, a run longer than
w + k, and everywhere); ptxas's report and the resident blocks per SM; and
the v1 and single-sequence joins on the card against the same joins on
the CPU. They skip without a CUDA device. This file imports no jax, so it
also runs where jax is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from phi_tpu_torch.sketch import kernels as tk
from test_torch_smoke import smoke_module

# (k, w) of the narrow tiled kernels' edge tests: w = 1, a power of two,
# 33 and 34 (one doubling step more or less), k + w - 2 = 128
NARROW_EDGES = [(31, 25), (31, 99), (21, 1), (15, 16), (20, 33), (20, 34)]
# (k, w) of seq's edge tests: the main path's, w = 1, k + w - 2 = 128
SEQ_EDGE_KW = [(31, 25), (21, 1), (31, 99)]


def _inputs(seed, sb, rows=8):
    rng = np.random.default_rng(seed)
    row_lanes = (sb + 1) * tk.BLK
    codes = torch.from_numpy(rng.integers(0, 4, (rows, row_lanes),
                                          dtype=np.uint8))
    nd = torch.from_numpy((rng.random((rows, row_lanes)) < 0.06)
                          .astype(np.uint8))
    nd[:, 0] = 0
    full = sb * tk.BLK
    nvalid = torch.tensor([full, 1000, 0, 5 * tk.BLK + 7] * (rows // 4),
                          dtype=torch.int32)
    left = torch.tensor([-1, 2, -1, 0] * (rows // 4), dtype=torch.int32)
    node_off = tk.block_node_offsets(
        nd, torch.from_numpy(rng.integers(0, 99, rows).astype(np.int32)), sb)
    return codes, nd, nvalid, left, node_off


def _edge_inputs(seed, sb=4):
    """16 rows at the tiled design's edges: nvalid 0, 1, at every
    1024-lane tile edge of a block, 8191, 8193, one block and a tile edge
    plus one, full; a poly-A row and a period-2 row (every key ties); left
    bases present and absent; node starts of 1-3, a few saturated at 255."""
    rng = np.random.default_rng(seed)
    row_lanes = (sb + 1) * tk.BLK
    full = sb * tk.BLK
    nvalid = [0, 1, 1024, 2048, 3072, 4096, 5120, 6144, 7168, 8191, 8192,
              8193, tk.BLK + 1025, full - 1, full, full - 77]
    codes = rng.integers(0, 4, (16, row_lanes), dtype=np.uint8)
    codes[14] = 0
    codes[15] = np.resize(np.array([0, 1], np.uint8), row_lanes)
    left = np.where(np.arange(16) % 3 == 0, -1, rng.integers(0, 4, 16))
    nd = (rng.random((16, row_lanes)) < 0.1) * rng.integers(1, 4,
                                                           (16, row_lanes))
    nd[rng.random((16, row_lanes)) < 0.001] = 255
    nd[:, 0] = 0
    nd = torch.from_numpy(nd.astype(np.uint8))
    node_off = tk.block_node_offsets(
        nd, torch.from_numpy(rng.integers(0, 99, 16).astype(np.int32)), sb)
    return (torch.from_numpy(codes), nd,
            torch.tensor(nvalid, dtype=torch.int32),
            torch.from_numpy(left.astype(np.int32)), node_off)


@pytest.mark.cuda
@pytest.mark.parametrize("k,w,C", [(31, 25, None), (21, 11, None),
                                   (15, 5, 256)])
def test_rows3_kernel_matches_twin_on_card(k, w, C):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    C = C or tk.block_cap(w)
    args = tuple(a.cuda() for a in _inputs(k, tk.SUPER_BLOCKS))
    want = tk.sketch_rows3_torch(*args, k, w, C)
    before = tk.sketch_rows3.launches
    got = tk.sketch_rows3(*args, k, w, C)
    torch.cuda.synchronize()
    assert tk.sketch_rows3.launches == before + 1
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("k,w", [(35, 25), (63, 11)])
def test_rows3w_kernel_matches_twin_on_card(k, w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    C = tk.block_cap(w)
    args = tuple(a.cuda() for a in _inputs(k, tk.SUPER_BLOCKS))
    want = tk.sketch_rows3w_torch(*args, k, w, C)
    before = tk.sketch_rows3w.launches
    got = tk.sketch_rows3w(*args, k, w, C)
    torch.cuda.synchronize()
    assert tk.sketch_rows3w.launches == before + 1
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_rows2_kernel_matches_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = tuple(a.cuda() for a in _inputs(2, tk.SUPER_BLOCKS))
    want = tk.sketch_rows2_torch(*args, 31, 25)
    before = tk.sketch_rows2.launches
    got = tk.sketch_rows2(*args, 31, 25)
    torch.cuda.synchronize()
    assert tk.sketch_rows2.launches == before + 1
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("k,w", NARROW_EDGES)
def test_rows2_edges_match_twin_on_card(k, w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = tuple(a.cuda() for a in _edge_inputs(k + w))
    want = tk.sketch_rows2_torch(*args, k, w)
    got = tk.sketch_rows2(*args, k, w)
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("k,w,C", [(35, 25, None), (63, 67, None),
                                   (40, 1, tk.BLK), (32, 11, 64),
                                   (40, 34, None)])
def test_rows3w_edges_match_twin_on_card(k, w, C):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    C = C or tk.block_cap(w)
    args = tuple(a.cuda() for a in _edge_inputs(k + w))
    want = tk.sketch_rows3w_torch(*args, k, w, C)
    got = tk.sketch_rows3w(*args, k, w, C)
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    if C == 64:
        assert bool((got[3] > C).any())


@pytest.mark.cuda
@pytest.mark.parametrize("k,w,C", [(k, w, None) for k, w in NARROW_EDGES]
                         + [(21, 11, 64)])
def test_rows3_edges_match_twin_on_card(k, w, C):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    C = C or tk.block_cap(w)
    args = tuple(a.cuda() for a in _edge_inputs(k + w))
    want = tk.sketch_rows3_torch(*args, k, w, C)
    got = tk.sketch_rows3(*args, k, w, C)
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    if C == 64:
        assert bool((got[2] > C).any())


@pytest.mark.cuda
@pytest.mark.parametrize("k,w", NARROW_EDGES)
def test_rows_edges_match_twin_on_card(k, w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    codes, _, nvalid, left, _ = (a.cuda() for a in _edge_inputs(k + w))
    want = tk.sketch_rows_torch(codes, nvalid, left, k, w)
    got = tk.sketch_rows(codes, nvalid, left, k, w)
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("k,w", SEQ_EDGE_KW)
@pytest.mark.parametrize("kind", smoke_module().SEQ_EDGES)
def test_seq_edges_match_twin_on_card(kind, k, w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    codes = smoke_module().seq_edge_codes(kind, k, w)
    args = tk._seq_tensors(codes, k, w, "cuda")
    want = tk.sketch_seq_torch(*args, k, w)
    got = tk.sketch_seq(*args, k, w)
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    if kind == "all N":
        assert not bool(got[2].any()) and bool((got[1] == -1).all())


@pytest.mark.cuda
def test_tiled_wrappers_refuse_unaligned_codes_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    codes, nd, nvalid, left, node_off = (a.cuda() for a in _inputs(3, 2))
    shifted = torch.empty(codes.numel() + 1, dtype=torch.uint8,
                          device="cuda")[1:].view(codes.shape)
    shifted.copy_(codes)
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        tk.sketch_rows3(shifted, nd, nvalid, left, node_off, 21, 11, 256)
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        tk.sketch_rows(shifted, nvalid, left, 21, 11)
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        tk.sketch_seq(shifted[:1], nvalid[:1], 21, 11)


@pytest.mark.cuda
def test_ptxas_and_resident_blocks_on_card():
    """None of the five kernels spills; rows3, rows3w, rows2, rows and seq
    run at 48 registers and 5, 4, 5, 5 and 5 resident blocks per SM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    smoke = smoke_module()
    report = smoke.ptxas_report(tk.build_log())
    for name in smoke.KERNELS:
        used, spill = report[name]
        assert used and not smoke.spills(spill), (name, used, spill)
        assert tk.occupancy(name) >= 1
    for name, blocks in (("rows3", 5), ("rows3w", 4), ("rows2", 5),
                         ("rows", 5), ("seq", 5)):
        assert report[name][0].startswith("Used 48 registers"), report[name]
        assert tk.occupancy(name) == blocks


def _seq_with_n(seed, n):
    """A/C/G/T with N runs, one across the first block boundary."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    codes[tk.BLK - 20:tk.BLK + 15] = 4
    for at in rng.integers(0, n - 100, 12):
        codes[at:at + rng.integers(1, 60)] = 4
    return codes


@pytest.mark.cuda
@pytest.mark.parametrize("k,w", [(31, 25), (21, 11)])
def test_rows_kernel_matches_twin_on_card(k, w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    codes, _, nvalid, left, _ = (a.cuda() for a in _inputs(k + 7,
                                                           tk.SUPER_BLOCKS))
    want = tk.sketch_rows_torch(codes, nvalid, left, k, w)
    before = tk.sketch_rows.launches
    got = tk.sketch_rows(codes, nvalid, left, k, w)
    torch.cuda.synchronize()
    assert tk.sketch_rows.launches == before + 1
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("k,w", [(31, 25), (15, 5)])
def test_seq_kernel_matches_twin_on_card(k, w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    codes, nvalid = tk._seq_tensors(_seq_with_n(k, 300_000), k, w, "cuda")
    want = tk.sketch_seq_torch(codes, nvalid, k, w)
    before = tk.sketch_seq.launches
    got = tk.sketch_seq(codes, nvalid, k, w)
    torch.cuda.synchronize()
    assert tk.sketch_seq.launches == before + 1
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_joins_on_card_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    seqs = [rng.integers(0, 4, n, dtype=np.uint8)
            for n in (3 * tk.BLK + 500, 40_000, 30)]
    seqs.append(_seq_with_n(6, 20_000))
    keys = np.unique(rng.integers(0, 1 << 62, 3000, dtype=np.int64))
    # half the spectrum from the sequences' own minimizers, so there are hits
    own = tk.sketch_sequence(seqs[0], 21, 11, device="cpu")
    own = (own[0].astype(np.int64) << 32) | own[1]
    keys = np.unique(np.concatenate([keys, own[::2]]))
    sp_hi = (keys >> 32).astype(np.uint32)
    sp_lo = (keys & 0xFFFFFFFF).astype(np.uint32)
    kw = dict(rows_per_call=2, super_blocks=2)
    want = tk.join_many(seqs, 21, 11, sp_hi, sp_lo, device="cpu", **kw)
    got = tk.join_many(seqs, 21, 11, sp_hi, sp_lo, device="cuda", **kw)
    assert got[3] is None and want[3] is None
    for a, b in zip(want[:3], got[:3]):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    assert len(want[0][1]) > 0
    for s in (seqs[0], seqs[3]):
        a = tk.join_sequence(s, 21, 11, sp_hi, sp_lo, device="cpu")
        b = tk.join_sequence(s, 21, 11, sp_hi, sp_lo, device="cuda")
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
