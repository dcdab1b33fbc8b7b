"""The v2 route past the cuckoo table: the port's rows2 twin against the
Pallas kernel in interpret mode, batch by batch; the dense node plane; the
mixed-bucket table and probe against phi_tpu.ops.search; join_rows2 and
join_rows2_ck against _pallas_join_rows2 and _pallas_join_rows2_ck, and
join_rows2_ck against the port's own join_rows3; the v2 mixed and v2
cuckoo routes of join_anchors_device; run_pipeline end to end through v2
mixed; and the emitted-lane overflow refusal. Outputs must be
array-equal."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from phi_tpu.ops import search as js  # noqa: E402
from phi_tpu.sketch import kernels as jk  # noqa: E402
from phi_tpu_torch import state  # noqa: E402
from phi_tpu_torch.anchors.device import (join_anchors_device,  # noqa: E402
                                          pack_batch)
from phi_tpu_torch.ops import search as ts  # noqa: E402
from phi_tpu_torch.sketch import kernels as tk  # noqa: E402
from test_torch_anchors import _compare, _spectrum  # noqa: E402
from test_torch_anchors import _instance as _graph_instance  # noqa: E402
from test_torch_kernels import (ROW_LANES, SB, R, _batches,  # noqa: E402
                                _edge_walks, _instance, _ref_codes)
from test_torch_pipeline import _mosaic, jax_device_path  # noqa: E402,F401
from test_torch_rows3w import _dense_chop, _reads  # noqa: E402

M32 = 0xFFFFFFFF

_ref_sketch2 = jax.jit(jk._pallas_sketch_rows2, static_argnames=(
    "k", "w", "n_rows", "n_blocks", "interpret"))


def _ref_packed2(seqs, cumlens, batch):
    """The reference's own v2 packers for one batch."""
    return (jk._pack_rows_2bit(seqs, batch, ROW_LANES),
            jk.pack_row_deltas(cumlens, batch, ROW_LANES),
            np.array([r[2] for r in batch], np.int32),
            np.array([r[3] for r in batch], np.int32),
            jk.row_base_nodes(cumlens, batch),
            np.array([max(r[0], 0) for r in batch], np.int32))


def _port_tensors(seqs, cumlens, batch):
    return state.batch_tensors(*pack_batch(seqs, cumlens, batch, ROW_LANES,
                                           None), "cpu")


@pytest.mark.parametrize("k,w,case", [
    pytest.param(21, 7, None, id="21-7"),
    pytest.param(31, 25, None, id="31-25"),
    pytest.param(31, 25, "ties", id="31-25-ties"),
    pytest.param(31, 25, "edges", id="31-25-edges"),
    pytest.param(15, 1, None, id="15-1"),
    pytest.param(31, 99, None, id="31-99")])
def test_rows2_twin_matches_pallas(k, w, case):
    seqs, cumlens = _edge_walks(k, w, case)
    batches, _ = _batches(seqs, cumlens, k, w)
    carry = jnp.zeros(3, jnp.uint32)
    saw_cont = False
    for batch in batches:
        words, deltas, nv, cont, base, _ = _ref_packed2(seqs, cumlens, batch)
        hi, lo, se, emit, carry = _ref_sketch2(
            jnp.asarray(_ref_codes(words)), jnp.asarray(deltas),
            jnp.asarray(nv), jnp.asarray(cont), jnp.asarray(base), carry,
            k=k, w=w, n_rows=R, n_blocks=SB, interpret=True)
        t_words, t_deltas, t_nv, t_left, t_base, _ = _port_tensors(
            seqs, cumlens, batch)
        assert np.array_equal(t_deltas.numpy(), deltas)
        codes = tk.unpack_2bit(t_words, ROW_LANES)
        node_off = tk.block_node_offsets(t_deltas, t_base, SB)
        key, pse, pemit = tk.sketch_rows2(codes, t_deltas, t_nv, t_left,
                                          node_off, k, w)
        emit = np.asarray(emit) != 0
        assert np.array_equal(pemit.numpy(), emit)
        assert np.array_equal(pse.numpy(), np.asarray(se).astype(np.int64))
        key = key.numpy()[emit]
        assert np.array_equal((key >> 32) & M32, np.asarray(hi)[emit])
        assert np.array_equal(key & M32, np.asarray(lo)[emit])
        saw_cont |= bool(cont[0])
    assert saw_cont


def test_rows2_wrapper_checks_inputs():
    codes = torch.zeros((1, ROW_LANES), dtype=torch.uint8)
    one = torch.zeros(1, dtype=torch.int32)
    off = torch.zeros((1, SB), dtype=torch.int32)
    with pytest.raises(ValueError, match="1 <= k <= 31"):
        tk.sketch_rows2(codes, codes, one, one, off, 35, 11)
    with pytest.raises(ValueError, match="rows2 left"):
        tk.sketch_rows2(codes, codes, one, one.long(), off, 21, 11)


def _mixed_spectrum(rng, n):
    hi = rng.integers(0, 1 << 30, n, dtype=np.uint64)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    # a skewed corner: many keys sharing hi = 0
    hi[:n // 4] = 0
    key = np.unique((hi << np.uint64(32)) | lo)
    return ((key >> np.uint64(32)).astype(np.uint32),
            (key & np.uint64(M32)).astype(np.uint32))


@pytest.mark.parametrize("n", [1, 3000, 70_000])
def test_make_mixed_buckets_matches_jax(n):
    sp_hi, sp_lo = _mixed_spectrum(np.random.default_rng(n), n)
    for bucket in (n, 1 << 15, 3 << 20, 1 << 23):
        assert ts.mixed_bits_for(bucket) == js.mixed_bits_for(bucket)
    bits = ts.mixed_bits_for(n)
    want = js.make_mixed_buckets(sp_hi, sp_lo, bits)
    got = ts.make_mixed_buckets(sp_hi, sp_lo, bits)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_pair_isin_mixed_matches_jax():
    """On the reference's own padded table (sentinel slots m = lo = UMAX,
    perm -1): members, random non-members, dead (UMAX, UMAX) queries and a
    query whose mixed key equals the sentinel's."""
    from phi_tpu.sketch.minimizer import prepare_spectrum_bucket
    rng = np.random.default_rng(2)
    sp_hi, sp_lo = _mixed_spectrum(rng, 20_000)
    m, lo, perm, off, Sb, rounds, bits = prepare_spectrum_bucket(sp_hi,
                                                                 sp_lo)
    assert Sb > len(sp_hi)
    pick = rng.integers(0, len(sp_hi), 3000)
    # (q_hi, q_lo) with q_hi*C1 + q_lo*C2 == UMAX and q_lo == UMAX
    s_hi = np.uint32((((M32 - M32 * js.MIX_C2) % (1 << 32))
                      * pow(js.MIX_C1, -1, 1 << 32)) % (1 << 32))
    q_hi = np.concatenate([sp_hi[pick],
                           rng.integers(0, 1 << 30, 2999).astype(np.uint32),
                           [s_hi], np.full(500, M32, np.uint32)])
    q_lo = np.concatenate([sp_lo[pick],
                           rng.integers(0, 1 << 32, 2999).astype(np.uint32),
                           [M32], np.full(500, M32, np.uint32)])
    f_want, i_want = js.pair_isin_mixed(
        *(jnp.asarray(a) for a in (m, lo, perm, off, q_hi, q_lo)), rounds,
        bits)
    cols = [torch.from_numpy(np.asarray(a, np.int64)) for a in
            (m, lo, perm, off)]
    q = state.spectrum_keys(q_hi, q_lo, "cpu")
    f_got, i_got = ts.pair_isin_mixed(*cols, q, rounds, bits)
    assert np.array_equal(f_got.numpy(), np.asarray(f_want))
    assert np.array_equal(i_got.numpy(), np.asarray(i_want))
    assert f_got[:3000].all() and not f_got[-501:].any()
    assert np.array_equal(i_got[:3000].numpy(), pick)
    # and on the port's own (unpadded) table: the same answers
    m2, lo2, perm2, off2, rounds2, bits2 = ts.mixed_tensors(sp_hi, sp_lo,
                                                            "cpu")
    f2, i2 = ts.pair_isin_mixed(m2, lo2, perm2, off2, q, rounds2, bits2)
    assert np.array_equal(f2.numpy(), f_got.numpy())
    assert np.array_equal(i2[f2].numpy(), i_got[f_got].numpy())


def _join_case(k, w):
    """Walks with a random 1-30 bp chop and reads drawn from walk 0 plus
    random sequence: hits and misses."""
    from phi_tpu import native
    seqs, cumlens = _instance(3, [40_000, 7_000, 18_000])
    rng = np.random.default_rng(4)
    parts = _reads(seqs, rng)
    concat = np.concatenate(parts)
    off = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
    uniq = np.unique(native.spectrum_native(concat, off, k, w))
    return (seqs, cumlens, (uniq >> np.uint64(32)).astype(np.uint32),
            (uniq & np.uint64(M32)).astype(np.uint32))


def _check_join(got, ref):
    n_min, n_hit, f_se, f_id, f_hap = (x.numpy() for x in got[:5])
    n = int(n_hit.sum())
    assert np.array_equal(n_min, np.asarray(ref[0]))
    assert np.array_equal(n_hit, np.asarray(ref[1]))
    assert np.array_equal(f_se[:n], np.asarray(ref[2])[:n])
    assert np.array_equal(f_id[:n], np.asarray(ref[3])[:n])
    assert np.array_equal(f_hap[:n], np.asarray(ref[4])[:n])
    return n


def test_join_rows2_matches_pallas():
    from phi_tpu.sketch.minimizer import prepare_spectrum_bucket
    k, w = 21, 11
    seqs, cumlens, sp_hi, sp_lo = _join_case(k, w)
    m, lo, perm, off, _, rounds, _ = prepare_spectrum_bucket(sp_hi, sp_lo)
    table = ts.mixed_tensors(sp_hi, sp_lo, "cpu")
    emitcap = tk.emit_cap(w, SB)
    cap_total = tk.hit_cap(w, SB, R)
    assert (emitcap, cap_total) == jk.join_caps(w, SB, R)
    batches, _ = _batches(seqs, cumlens, k, w)
    carry = jnp.zeros(3, jnp.uint32)
    hits = 0
    for batch in batches:
        words, deltas, nv, cont, base, hap = _ref_packed2(seqs, cumlens,
                                                          batch)
        ref = jk._pallas_join_rows2(
            *(jnp.asarray(a) for a in (words, deltas, nv, cont, base, hap)),
            carry, *(jnp.asarray(a) for a in (m, lo, perm, off)),
            jnp.int32(rounds), k=k, w=w, n_rows=R, n_blocks=SB,
            emitcap=emitcap, cap_total=cap_total, interpret=True)
        carry = ref[5]
        got = tk.join_rows2(*_port_tensors(seqs, cumlens, batch), table, k,
                            w, SB, emitcap, cap_total)
        hits += _check_join(got, ref)
    assert hits > 0


def test_join_rows2_ck_matches_pallas_and_rows3():
    """join_rows2_ck against _pallas_join_rows2_ck, and its flat hit
    stream against the port's join_rows3 on the same batch (the port's
    counterpart of test_v3_kernel_matches_v2)."""
    from phi_tpu_torch.anchors.device import _row_start_cap
    k, w = 21, 11
    seqs, cumlens, sp_hi, sp_lo = _join_case(k, w)
    ck = ts.make_cuckoo(sp_hi, sp_lo)
    Thi, Tlo, Tid, seed, _ = ck
    tkey, tid, tseed = state.cuckoo_tensors(ck, "cpu")
    emitcap = tk.emit_cap(w, SB)
    cap_total = tk.hit_cap(w, SB, R)
    batches, _ = _batches(seqs, cumlens, k, w)
    S_cap = _row_start_cap(cumlens, [r for b in batches for r in b],
                           ROW_LANES)
    carry = jnp.zeros(3, jnp.uint32)
    hits = 0
    for batch in batches:
        words, deltas, nv, cont, base, hap = _ref_packed2(seqs, cumlens,
                                                          batch)
        ref = jk._pallas_join_rows2_ck(
            *(jnp.asarray(a) for a in (words, deltas, nv, cont, base, hap)),
            carry, jnp.asarray(Thi), jnp.asarray(Tlo), jnp.asarray(Tid),
            jnp.uint32(seed), k=k, w=w, n_rows=R, n_blocks=SB,
            emitcap=emitcap, cap_total=cap_total, interpret=True)
        carry = ref[5]
        got = tk.join_rows2_ck(*_port_tensors(seqs, cumlens, batch), tkey,
                               tid, tseed, k, w, SB, emitcap, cap_total)
        n = _check_join(got, ref)
        hits += n
        v3 = tk.join_rows3(
            *state.batch_tensors(*pack_batch(seqs, cumlens, batch,
                                             ROW_LANES, S_cap), "cpu"),
            tkey, tid, tseed, k, w, SB, tk.block_cap(w), cap_total)
        for a, b in zip(got[:2], v3[:2]):
            assert torch.equal(a, b)
        for a, b in zip(got[2:5], v3[2:5]):
            assert torch.equal(a[:n], b[:n])
    assert hits > 0


def _spy(monkeypatch, name):
    """Count the calls of the join `name` made by join_anchors_device."""
    from phi_tpu_torch.anchors import device as tdev
    fn = getattr(tdev, name)
    calls = []

    def counted(*args):
        calls.append(1)
        return fn(*args)

    monkeypatch.setattr(tdev, name, counted)
    return calls


@pytest.fixture
def small_cuckoo_limit(monkeypatch):
    """Both packages' cuckoo limit lowered, so a small spectrum takes the
    v2 mixed route (a test-only patch of the existing constant)."""
    monkeypatch.setattr(js, "CUCKOO_MAX_KEYS", 100)
    monkeypatch.setattr(ts, "CUCKOO_MAX_KEYS", 100)


def test_v2_mixed_route_matches_jax(tmp_path, small_cuckoo_limit,
                                    monkeypatch):
    k, w = 21, 11
    graph, reads = _graph_instance(tmp_path)
    sp = _spectrum(reads, k, w)
    assert len(sp[0]) > 100
    calls = _spy(monkeypatch, "join_rows2")
    occ = _compare(graph, sp, k, w, 0.5, 2)
    assert occ.n_occ > 0 and occ.filtered > 0
    assert calls


def test_v2_cuckoo_route_matches_jax(tmp_path, monkeypatch):
    """1-3 bp nodes: the node chop is denser than one start per 4 bases."""
    k, w = 15, 5
    graph, reads = _dense_chop(tmp_path)
    calls = _spy(monkeypatch, "join_rows2_ck")
    occ = _compare(graph, _spectrum(reads, k, w), k, w, 1.0, 1)
    assert occ.n_occ > 0
    assert calls


def test_pipeline_v2_mixed_matches_jax(tmp_path, jax_device_path,
                                       small_cuckoo_limit, monkeypatch):
    from phi_tpu.config import Options as JaxOptions
    from phi_tpu_torch.anchors import device as tdev
    from phi_tpu_torch.config import Options
    from phi_tpu_torch.pipeline import run_pipeline
    monkeypatch.setattr(tdev, "ROWS", R)
    monkeypatch.setattr(tdev, "SUPER_BLOCKS", SB)
    gfa_path, reads_path = _mosaic(tmp_path)
    want = jax_device_path(gfa_path, reads_path, str(tmp_path / "jax.fa"),
                           JaxOptions(recombination=5.0))
    calls = _spy(monkeypatch, "join_rows2")
    got = run_pipeline(gfa_path, reads_path, str(tmp_path / "torch.fa"),
                       Options(recombination=5.0), device="cpu")
    assert calls
    with open(tmp_path / "jax.fa", "rb") as a, \
            open(tmp_path / "torch.fa", "rb") as b:
        assert a.read() == b.read()
    assert got.recombination_count == want.recombination_count
    assert got.report_segments == want.report_segments
    assert got.decode.dp_objective == pytest.approx(
        want.decode.dp_objective, abs=1e-3)
    assert got.decode.true_objective == pytest.approx(
        want.decode.true_objective, abs=1e-3)
    assert got.anchors.n_model_kmers == want.anchors.n_model_kmers
    assert got.anchors.filtered_kmers == want.anchors.filtered_kmers


def test_v2_emit_overflow_names_its_condition(tmp_path, small_cuckoo_limit,
                                              monkeypatch, capsys):
    """A v2 emitted-lane overflow: both packages return None (the host hit
    path), and the port names the condition."""
    from phi_tpu.anchors.device import join_anchors_device as jax_join
    from phi_tpu_torch.anchors import device as tdev
    (jgraph, graph), reads = _graph_instance(tmp_path)
    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    sp = _spectrum(reads, 21, 11)
    caps = jk.join_caps
    monkeypatch.setattr(jk, "join_caps",
                        lambda w, sb, r: (64, caps(w, sb, r)[1]))
    monkeypatch.setattr(tdev, "emit_cap", lambda w, sb: 64)
    assert jax_join(jgraph, seqs, 21, 11, sp[0], sp[1], 1.0,
                    rows_per_call=R, super_blocks=SB, interpret=True) is None
    assert join_anchors_device(graph, seqs, 21, 11, sp[0], sp[1], 1.0,
                               device="cpu", rows_per_call=R,
                               super_blocks=SB) is None
    assert "v2 emitted-lane overflow" in capsys.readouterr().err
