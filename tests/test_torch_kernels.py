"""rows3 sketch parity: the port's plain twin (sketch_rows3 on CPU tensors)
against the Pallas kernel in interpret mode, batch by batch, and the whole
batch join against _pallas_join_rows3_ck. The reference chains its dedup
carry across rows and batches; the port recomputes it from one base to the
left of each row, so rows that continue a walk across a batch boundary are
covered. Outputs must be array-equal."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from phi_tpu.anchors import device as jdev  # noqa: E402
from phi_tpu.sketch import kernels as jk  # noqa: E402
from phi_tpu_torch import state  # noqa: E402
from phi_tpu_torch.anchors.device import (_row_start_cap, pack_batch,  # noqa: E402
                                          plan_rows)
from phi_tpu_torch.ops.search import make_cuckoo  # noqa: E402
from phi_tpu_torch.sketch import kernels as tk  # noqa: E402

R, SB = 2, 2
ROW_LANES = (SB + 1) * tk.BLK
M32 = 0xFFFFFFFF

_ref_sketch = jax.jit(jk._pallas_sketch_rows3, static_argnames=(
    "k", "w", "n_rows", "n_blocks", "C", "interpret"))


def _chop(rng, L):
    """Node offsets (cumlen) over L bases: 1-30 bp nodes with runs of
    zero-length nodes mixed in (several node starts at one base)."""
    lens = []
    total = 0
    while total < L:
        if rng.random() < 0.05:
            lens += [0] * int(rng.integers(1, 4))
        n = int(min(rng.integers(1, 31), L - total))
        lens.append(n)
        total += n
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


def _instance(seed, lengths, repeat=None):
    rng = np.random.default_rng(seed)
    seqs = []
    for L in lengths:
        if repeat is not None:
            s = np.resize(np.array(repeat, np.uint8), L)
        else:
            s = rng.integers(0, 4, L).astype(np.uint8)
        seqs.append(s)
    return seqs, [_chop(rng, len(s)) for s in seqs]


def _edge_walks(k, w, case):
    """Walks at the card kernels' edges. None: walk 0 spans 3 rows (its
    third row continues across a batch boundary), walk 1 is shorter than
    one block, walk 2 is periodic. "ties": a poly-A walk of 3 rows and a
    period-2 walk, where every key ties. "edges": rows whose nvalid is 1,
    a 1024-lane tile, 8191, 8193, and a walk of 3 rows whose last holds 3
    tiles; a pad row has none."""
    if case == "edges":
        halo = k + w - 2
        return _instance(k, [halo + n for n in (1, 1024, 8191, 8193,
                                                2 * SB * tk.BLK + 3072)])
    seqs, cumlens = _instance(k, [40_000, 5_000, 20_000])
    if case == "ties":
        seqs[0] = np.zeros(40_000, np.uint8)
        seqs[1] = np.resize(np.array([0, 1], np.uint8), 5_000)
    else:
        seqs[2] = np.resize(np.array([0, 1, 2, 2, 3, 1, 0], np.uint8),
                            20_000)
    return seqs, cumlens


def _batches(seqs, cumlens, k, w):
    rows = plan_rows(seqs, k, w, SB)
    n_batches = -(-len(rows) // R)
    padded = rows + [(-1, 0, 0, 0)] * (n_batches * R - len(rows))
    S_cap = _row_start_cap(cumlens, rows, ROW_LANES)
    return [padded[b * R:(b + 1) * R] for b in range(n_batches)], S_cap


def _ref_packed(seqs, cumlens, batch, S_cap):
    """The reference's own packers for one batch."""
    return (jk._pack_rows_2bit(seqs, batch, ROW_LANES),
            jdev.pack_row_starts(cumlens, batch, ROW_LANES, S_cap),
            np.array([r[2] for r in batch], np.int32),
            np.array([r[3] for r in batch], np.int32),
            jk.row_base_nodes(cumlens, batch),
            np.array([max(r[0], 0) for r in batch], np.int32))


def _ref_codes(words):
    shifts = np.arange(16, dtype=np.uint32) * 2
    return ((words[:, :, None] >> shifts) & 3).astype(np.uint8) \
        .reshape(words.shape[0], -1)


def _split(key):
    key = key.numpy()
    return ((key >> 32) & M32).astype(np.uint32), (key & M32).astype(np.uint32)


def _compare_sketch(seqs, cumlens, k, w, C):
    batches, S_cap = _batches(seqs, cumlens, k, w)
    carry = jnp.zeros(3, jnp.uint32)
    saw_cont = saw_over = False
    for batch in batches:
        ref_p = _ref_packed(seqs, cumlens, batch, S_cap)
        mine = pack_batch(seqs, cumlens, batch, ROW_LANES, S_cap)
        for a, b in zip(ref_p[:3] + ref_p[4:], mine[:3] + mine[4:]):
            assert np.array_equal(a, b)
        words, starts, nv, cont, base, _ = ref_p
        hi, lo, se, cnt, carry = _ref_sketch(
            jnp.asarray(_ref_codes(words)),
            jk._delta_plane(jnp.asarray(starts), R, ROW_LANES),
            jnp.asarray(nv), jnp.asarray(cont), jnp.asarray(base), carry,
            k=k, w=w, n_rows=R, n_blocks=SB, C=C, interpret=True)
        t_words, t_starts, t_nv, t_left, t_base, _ = state.batch_tensors(
            *mine, "cpu")
        codes = tk.unpack_2bit(t_words, ROW_LANES)
        nd = tk.delta_plane(t_starts, ROW_LANES)
        node_off = tk.block_node_offsets(nd, t_base, SB)
        key, pse, pcnt = tk.sketch_rows3(codes, nd, t_nv, t_left, node_off,
                                         k, w, C)
        phi, plo = _split(key)
        assert np.array_equal(phi, np.asarray(hi))
        assert np.array_equal(plo, np.asarray(lo))
        assert np.array_equal(pse.numpy(), np.asarray(se).astype(np.int64))
        assert np.array_equal(pcnt.numpy(), np.asarray(cnt))
        saw_cont |= bool(cont[0])
        saw_over |= bool((np.asarray(cnt) > C).any())
    return saw_cont, saw_over


@pytest.mark.parametrize("k,w,case", [
    pytest.param(31, 25, None, id="31-25"),
    pytest.param(21, 11, None, id="21-11"),
    pytest.param(15, 5, None, id="15-5"),
    pytest.param(15, 1, None, id="15-1"),
    pytest.param(31, 99, None, id="31-99"),
    pytest.param(31, 25, "ties", id="31-25-ties"),
    pytest.param(31, 25, "edges", id="31-25-edges")])
def test_rows3_twin_matches_pallas(k, w, case):
    # walk 0 spans 3 rows, so its third row continues across the boundary
    # between batches 0 and 1; walk 1 is shorter than one block; the tiled
    # kernel's edges (_edge_walks) too
    if case is None:
        seqs, cumlens = _instance(k, [40_000, 5_000, 20_000])
    else:
        seqs, cumlens = _edge_walks(k, w, case)
    saw_cont, _ = _compare_sketch(seqs, cumlens, k, w, tk.block_cap(w))
    assert saw_cont


def test_rows3_twin_repetitive_and_overflow():
    """A periodic walk (long runs with no new minimizer) and blocks whose
    emitted count exceeds C: cnt stays exact, slots past C are dropped."""
    seqs, cumlens = _instance(5, [30_000], repeat=[0, 1, 2, 2, 3, 1, 0])
    _compare_sketch(seqs, cumlens, 21, 11, tk.block_cap(11))
    seqs, cumlens = _instance(6, [12_000, 9_000])
    _, saw_over = _compare_sketch(seqs, cumlens, 21, 11, 256)
    assert saw_over


def test_rows3_twin_diamond_zero_length_node(tmp_path):
    """tests/test_device_anchors.py's diamond: walk 2 passes an empty node,
    so two node starts fall on one base."""
    from phi_tpu.graph import tensorize
    from phi_tpu.io.gfa import read_gfa
    gfa = tmp_path / "z.gfa"
    gfa.write_text(
        "H\tVN:Z:1.1\n"
        "S\ts1\tACGTACGTAGCTTACGGATC\nS\ts2\tTTGCA\nS\ts3\t\n"
        "S\ts4\tGGATCCATTGCAAGGTCCAA\n"
        "L\ts1\t+\ts2\t+\t0M\nL\ts1\t+\ts3\t+\t0M\n"
        "L\ts2\t+\ts4\t+\t0M\nL\ts3\t+\ts4\t+\t0M\n"
        "W\tsamp\t1\tchr\t0\t45\t>s1>s2>s4\n"
        "W\tsamp\t2\tchr\t0\t40\t>s1>s3>s4\n")
    graph = tensorize(read_gfa(str(gfa)))
    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    assert (np.diff(graph.walk_node_cumlen[1]) == 0).any()
    _compare_sketch(seqs, graph.walk_node_cumlen, 9, 4, tk.block_cap(4))


def test_rows3_wrapper_checks_inputs():
    codes = torch.zeros((1, ROW_LANES), dtype=torch.uint8)
    nd = torch.zeros_like(codes)
    one = torch.zeros(1, dtype=torch.int32)
    off = torch.zeros((1, SB), dtype=torch.int32)
    with pytest.raises(ValueError, match="k \\+ w - 2"):
        tk.sketch_rows3(codes, nd, one, one, off, 31, 100, 256)
    with pytest.raises(ValueError, match="nd"):
        tk.sketch_rows3(codes, nd.to(torch.int32), one, one, off, 21, 11, 256)
    with pytest.raises(ValueError, match="contiguous"):
        tk.sketch_rows3(codes, nd, one, one,
                        torch.zeros((1, 2 * SB), dtype=torch.int32)[:, ::2],
                        21, 11, 256)


def test_delta_plane_saturates():
    starts = torch.tensor([[5] * 300 + [7, 7] + [ROW_LANES] * 10],
                          dtype=torch.int32)
    ref = np.asarray(jk._delta_plane(jnp.asarray(starts.numpy()), 1,
                                     ROW_LANES))
    got = tk.delta_plane(starts, ROW_LANES).numpy()
    assert np.array_equal(got, ref)
    assert got[0, 5] == 255 and got[0, 7] == 2


def test_join_rows3_matches_pallas():
    from phi_tpu import native
    k, w = 21, 11
    seqs, cumlens = _instance(3, [40_000, 7_000, 18_000])
    rng = np.random.default_rng(4)
    # reads from walk 0 plus random sequence: hits and misses
    parts = [seqs[0][s:s + 150] for s in rng.integers(0, 39_000, 300)]
    parts += [rng.integers(0, 4, 150).astype(np.uint8) for _ in range(100)]
    concat = np.concatenate(parts)
    off = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
    keys = native.spectrum_native(concat, off, k, w)
    if keys is None:
        pytest.skip("native library unavailable")
    uniq = np.unique(keys)
    sp_hi = (uniq >> np.uint64(32)).astype(np.uint32)
    sp_lo = (uniq & np.uint64(M32)).astype(np.uint32)
    ck = make_cuckoo(sp_hi, sp_lo)
    Thi, Tlo, Tid, seed, _ = ck
    tkey, tid, tseed = state.cuckoo_tensors(ck, "cpu")
    C = tk.block_cap(w)
    cap_total = tk.hit_cap(w, SB, R)
    assert cap_total == jk.join_caps(w, SB, R)[1]
    batches, S_cap = _batches(seqs, cumlens, k, w)
    carry = jnp.zeros(3, jnp.uint32)
    hits = 0
    for batch in batches:
        words, starts, nv, cont, base, hap = _ref_packed(seqs, cumlens,
                                                         batch, S_cap)
        ref = jk._pallas_join_rows3_ck(
            jnp.asarray(words), jnp.asarray(starts), jnp.asarray(nv),
            jnp.asarray(cont), jnp.asarray(base), jnp.asarray(hap), carry,
            jnp.asarray(Thi), jnp.asarray(Tlo), jnp.asarray(Tid),
            jnp.uint32(seed), k=k, w=w, n_rows=R, n_blocks=SB, C=C,
            cap_total=cap_total, interpret=True)
        carry = ref[5]
        got = tk.join_rows3(
            *state.batch_tensors(*pack_batch(seqs, cumlens, batch,
                                             ROW_LANES, S_cap), "cpu"),
            tkey, tid, tseed, k, w, SB, C, cap_total)
        n_min, n_hit, f_se, f_id, f_hap, cnt_max = (x.numpy() for x in got)
        assert np.array_equal(n_min, np.asarray(ref[0]))
        assert np.array_equal(n_hit, np.asarray(ref[1]))
        hits += int(n_hit.sum())
        assert np.array_equal(f_se, np.asarray(ref[2]).astype(np.int64))
        assert np.array_equal(f_id, np.asarray(ref[3]))
        assert np.array_equal(f_hap, np.asarray(ref[4]))
        assert np.array_equal(cnt_max, np.asarray(ref[6]))
    assert hits > 0
