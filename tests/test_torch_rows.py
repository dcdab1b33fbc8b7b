"""The v1 rows kernel and the single-sequence kernel on the CPU: the port's
twins (`sketch_rows_torch`, `sketch_seq_torch`) against the Pallas kernels
in interpret mode, and the port's `join_many`, `sketch_sequence` and
`join_sequence` against `pallas_join_many`, `pallas_sketch_sequence` and
`pallas_join_sequence`. Equality is exact. Hits are compared in the order
both packages return them (row-major flatten = position order per
sequence), not sorted: the native anchor tables need that order."""

import random

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import phi_tpu.sketch.minimizer as jm  # noqa: E402
from phi_tpu.io.gfa import encode_seq  # noqa: E402
from phi_tpu.sketch import kernels as jk  # noqa: E402
from phi_tpu_torch.sketch import kernels as tk  # noqa: E402

BLK = tk.BLK


def _key(hi, lo) -> np.ndarray:
    """The reference's (hi, lo) u32 pair as the port's int64 key; the dead
    pair (UMAX, UMAX) becomes -1, the port's dead key."""
    return ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64)).view(np.int64)


@pytest.mark.parametrize("k,w,kind", [
    pytest.param(17, 9, None, id="17-9"),
    pytest.param(31, 25, None, id="31-25"),
    pytest.param(15, 1, None, id="15-1"),
    pytest.param(31, 99, None, id="31-99"),
    pytest.param(31, 25, "poly-A", id="31-25-poly-A"),
    pytest.param(21, 11, "period-2", id="21-11-period-2")])
def test_rows_twin_matches_pallas(k, w, kind):
    """R = 2, SB = 2: row 0 starts a sequence and fills its row, row 1
    continues it (the reference's cont/carry, the port's left base) and is
    short. The sequence is random, or poly-A or period 2 (every key
    ties)."""
    rng = np.random.default_rng(k)
    sb = 2
    sup, row_lanes = sb * BLK, (sb + 1) * BLK
    seq = rng.integers(0, 4, sup + 3000, dtype=np.uint8)
    if kind == "poly-A":
        seq[:] = 0
    elif kind == "period-2":
        seq = np.resize(np.array([0, 1], np.uint8), len(seq))
    n_short = len(seq) - (k + w - 2) - sup
    rows = [(0, 0, sup, 0), (0, sup, n_short, 1)]
    buf = np.zeros((2, row_lanes), np.uint8)
    for j, (_, start, _, _) in enumerate(rows):
        seg = seq[start:start + row_lanes]
        buf[j, :len(seg)] = seg
    nvalid = np.array([sup, n_short], np.int32)
    hi, lo, pos, emit, _ = jk._pallas_sketch_rows(
        jnp.asarray(buf), jnp.asarray(nvalid), jnp.asarray([0, 1], jnp.int32),
        jnp.zeros(3, jnp.uint32), k, w, 2, sb, interpret=True)
    left = torch.from_numpy(tk.pack_row_left([seq], rows))
    key_t, pos_t, emit_t = tk.sketch_rows_torch(
        torch.from_numpy(buf), torch.from_numpy(nvalid), left, k, w)
    want_key = _key(hi, lo)
    for r in range(2):
        n = nvalid[r]
        np.testing.assert_array_equal(key_t[r, :n].numpy(), want_key[r, :n])
        np.testing.assert_array_equal(pos_t[r, :n].numpy(),
                                      np.asarray(pos)[r, :n])
        np.testing.assert_array_equal(emit_t[r, :n].numpy(),
                                      np.asarray(emit)[r, :n] != 0)
        # past nvalid the port writes dead lanes (the reference leaves the
        # window's key; only valid lanes are compared with it)
        assert (key_t[r, n:] == tk.DEAD_KEY).all()
        assert (pos_t[r, n:] == -1).all() and not emit_t[r, n:].any()
    assert int(emit_t.sum()) > 0


def _n_seq(kind: str) -> np.ndarray:
    rng = random.Random(3)
    seq = "".join(rng.choice("ACGT") for _ in range(30000))
    if kind == "n_bases":  # tests/test_pallas_kernel.py's sequence
        seq = seq[:9000] + "N" * 15 + seq[9015:]
        seq = seq[:16380] + "NN" + seq[16382:]
    elif kind == "boundary":  # N runs across a block boundary, both ends
        seq = "NNNNN" + seq[5:BLK - 20] + "N" * 40 + seq[BLK + 20:-3] + "NNN"
    elif kind == "edges":  # N at the card kernel's tile and block edges
        for at in (1023, BLK - 1, BLK + 2047, 2 * BLK - 1):
            seq = seq[:at] + "NN" + seq[at + 2:]
    else:  # all N
        seq = "N" * len(seq)
    return encode_seq(seq)


@pytest.mark.parametrize("kind,w", [
    pytest.param("n_bases", 7, id="n_bases"),
    pytest.param("boundary", 7, id="boundary"),
    pytest.param("edges", 7, id="edges"),
    pytest.param("all_n", 7, id="all_n"),
    pytest.param("boundary", 1, id="boundary-w1")])
def test_seq_twin_matches_pallas(kind, w):
    """Every valid lane: key, position and emit flag, including the windows
    whose k-mers all hold N (dead key -1, position -1, no emit)."""
    k = 13
    codes = _n_seq(kind)
    n_valid = len(codes) - k - w + 2
    buf, nv = tk._seq_tensors(codes, k, w, "cpu")
    n_blocks = buf.shape[1] // BLK - 1
    hi, lo, pos, emit = jk._pallas_sketch(
        jnp.asarray(buf.numpy()), jnp.asarray([[n_valid]], jnp.int32), k, w,
        n_blocks, interpret=True)
    key_t, pos_t, emit_t = tk.sketch_seq_torch(buf, nv, k, w)
    np.testing.assert_array_equal(key_t[0, :n_valid].numpy(),
                                  _key(hi, lo)[0, :n_valid])
    np.testing.assert_array_equal(pos_t[0, :n_valid].numpy(),
                                  np.asarray(pos)[0, :n_valid])
    np.testing.assert_array_equal(emit_t[0, :n_valid].numpy(),
                                  np.asarray(emit)[0, :n_valid] != 0)
    assert (pos_t[0, :n_valid] == -1).any()  # some windows are all N
    assert (kind == "all_n") == (not emit_t.any())


def _spectrum(seqs, k, w):
    """The read spectrum of 90 bp fragments (every 83 bp) of seqs."""
    frags = [s[i:i + 90] for s in seqs for i in range(0, len(s) - 90, 83)]
    rc = np.full((len(frags), 90), 4, np.uint8)
    ln = np.zeros(len(frags), np.int32)
    for i, f in enumerate(frags):
        rc[i, :len(f)] = f
        ln[i] = len(f)
    sp_hi, sp_lo = jm.sketch_read_batch(rc, k, w, ln)
    return np.asarray(sp_hi), np.asarray(sp_lo)


def _many_seqs():
    """tests/test_pallas_kernel.py::test_pallas_join_many_batched_rows's
    sequences (the fifth holds N), plus an empty and a tiny one."""
    rng = random.Random(77)
    seqs = [encode_seq("".join(rng.choice("ACGT") for _ in range(n)))
            for n in (50000, 2 * BLK + 40, 123, 70000)]
    seqs.append(encode_seq("ACGT" * 5000 + "N" + "ACGT" * 5000))
    seqs += [np.zeros(0, np.uint8), encode_seq("ACGTACGT")]
    return seqs


def _assert_hits_equal(got, want):
    assert len(got) == len(want)
    for i, (g, x) in enumerate(zip(got, want)):
        if x is None:
            assert g is None, f"seq {i}"
            continue
        assert g[0] == x[0], f"seq {i}: n_min {g[0]} != {x[0]}"
        np.testing.assert_array_equal(g[1], x[1], err_msg=f"seq {i} pos")
        np.testing.assert_array_equal(g[2], x[2], err_msg=f"seq {i} ids")
        assert g[1].dtype == np.int32 and g[2].dtype == np.int32


def test_join_many_matches_pallas():
    k, w = 17, 9
    seqs = _many_seqs()
    sp_hi, sp_lo = _spectrum([seqs[0], seqs[3]], k, w)
    want = jk.pallas_join_many(seqs, k, w, jnp.asarray(sp_hi),
                               jnp.asarray(sp_lo), rows_per_call=2,
                               super_blocks=2, interpret=True)
    got = tk.join_many(seqs, k, w, sp_hi, sp_lo, device="cpu",
                       rows_per_call=2, super_blocks=2)
    assert got[4] is None
    assert got[5][0] == 0 and got[6][0] == 0
    assert len(got[0][1]) > 0 and len(got[3][1]) > 0
    _assert_hits_equal(got, want)


def test_join_many_reruns_overflowing_batches(monkeypatch):
    """Caps far below the emitted lanes and hits: each batch reruns with
    raised caps and the result is the same as with the reference's caps."""
    k, w = 17, 9
    seqs = _many_seqs()
    sp_hi, sp_lo = _spectrum([seqs[0], seqs[3]], k, w)
    kw = dict(device="cpu", rows_per_call=2, super_blocks=2)
    want = tk.join_many(seqs, k, w, sp_hi, sp_lo, **kw)
    calls = []
    real = tk.join_rows
    monkeypatch.setattr(tk, "emit_cap", lambda w, sb: 16)
    monkeypatch.setattr(tk, "hit_cap", lambda w, sb, R: 8)
    monkeypatch.setattr(tk, "join_rows",
                        lambda *a: calls.append(a[-2:]) or real(*a))
    _assert_hits_equal(tk.join_many(seqs, k, w, sp_hi, sp_lo, **kw), want)
    assert (16, 8) in calls and any(c != (16, 8) for c in calls)


def test_join_many_empty_spectrum():
    seqs = _many_seqs()[:2]
    z = np.zeros(0, np.uint32)
    got = tk.join_many(seqs, 17, 9, z, z, device="cpu", rows_per_call=2,
                       super_blocks=2)
    for n_min, pos, ids in got:
        assert n_min > 0 and len(pos) == 0 and len(ids) == 0


@pytest.mark.parametrize("kind", ["n_bases", "boundary"])
def test_sketch_sequence_matches_pallas(kind):
    k, w = 13, 7
    codes = _n_seq(kind)
    want = jk.pallas_sketch_sequence(codes, k, w, interpret=True)
    got = tk.sketch_sequence(codes, k, w, device="cpu")
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)
    # the host scan agrees too (the reference's own contract)
    for g, x in zip(got, jm.sketch_sequence(codes, k, w)):
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("kind", ["acgt", "n_bases", "short"])
def test_join_sequence_matches_pallas(kind):
    k, w = 17, 9
    rng = random.Random(8)
    codes = encode_seq("".join(rng.choice("ACGT") for _ in range(40000)))
    sp_hi, sp_lo = _spectrum([codes[:30090]], k, w)
    if kind == "n_bases":
        codes = codes.copy()
        codes[BLK - 30:BLK + 10] = 4
        codes[20000:20003] = 4
    elif kind == "short":
        codes = codes[:k + w - 2]
    want = jk.pallas_join_sequence(codes, k, w, jnp.asarray(sp_hi),
                                   jnp.asarray(sp_lo), interpret=True)
    got = tk.join_sequence(codes, k, w, sp_hi, sp_lo, device="cpu")
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    if kind != "short":
        assert len(got[1]) > 0


def test_wrappers_take_the_twin_on_cpu():
    """On CPU tensors the wrappers return the twins' outputs and count no
    launch; another device raises."""
    rng = np.random.default_rng(4)
    codes = torch.from_numpy(rng.integers(0, 4, (2, 3 * BLK), dtype=np.uint8))
    nvalid = torch.tensor([2 * BLK, 777], dtype=torch.int32)
    left = torch.tensor([-1, 2], dtype=torch.int32)
    before = (tk.sketch_rows.launches, tk.sketch_seq.launches)
    for got, want in ((tk.sketch_rows(codes, nvalid, left, 21, 11),
                       tk.sketch_rows_torch(codes, nvalid, left, 21, 11)),
                      (tk.sketch_seq(codes, nvalid, 21, 11),
                       tk.sketch_seq_torch(codes, nvalid, 21, 11))):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert (tk.sketch_rows.launches, tk.sketch_seq.launches) == before
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tk.sketch_rows(codes.to("meta"), nvalid.to("meta"), left.to("meta"),
                       21, 11)


@pytest.mark.parametrize("bad", ["dtype", "shape", "k", "left"])
def test_rows_rejects_bad_inputs(bad):
    codes = torch.zeros((2, 3 * BLK), dtype=torch.uint8)
    nvalid = torch.zeros(2, dtype=torch.int32)
    left = torch.full((2,), -1, dtype=torch.int32)
    k = 21
    if bad == "dtype":
        codes = codes.to(torch.int32)
    elif bad == "shape":
        codes = codes[:, :BLK + 5].contiguous()
    elif bad == "k":
        k = 35
    else:
        left = left[:1]
    with pytest.raises(ValueError):
        tk.sketch_rows(codes, nvalid, left, k, 11)
