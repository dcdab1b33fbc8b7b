"""Wide k (31 < k <= 63) parity: the port's rows3w twin against the Pallas
kernel in interpret mode, batch by batch; the torch fold against
fold128_64_np; the read spectrum at k = 35; join_rows3w against
_pallas_join_rows3w_ck; the wide route of join_anchors_device; run_pipeline
end to end at k = 35; and the refusals that remain. Outputs must be
array-equal."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from phi_tpu.sketch import kernels as jk  # noqa: E402
from phi_tpu.sketch.encode import fold128_64_np  # noqa: E402
from phi_tpu_torch import state  # noqa: E402
from phi_tpu_torch.anchors.device import (join_anchors_device,  # noqa: E402
                                          pack_batch)
from phi_tpu_torch.ops.search import make_cuckoo  # noqa: E402
from phi_tpu.anchors.device import join_anchors_device as jax_join  # noqa: E402
from phi_tpu_torch.sketch import kernels as tk  # noqa: E402
from test_torch_anchors import _compare, _graphs  # noqa: E402
from test_torch_anchors import _instance as _graph_instance  # noqa: E402
from test_torch_kernels import (ROW_LANES, SB, R, _batches,  # noqa: E402
                                _edge_walks, _instance, _ref_codes,
                                _ref_packed)
from test_torch_pipeline import _mosaic, jax_device_path  # noqa: E402,F401

M32 = 0xFFFFFFFF

_ref_sketch_w = jax.jit(jk._pallas_sketch_rows3w, static_argnames=(
    "k", "w", "n_rows", "n_blocks", "C", "interpret"))


def _words(t):
    """int64 [R, n] -> its two u32 words (hi, lo)."""
    a = t.numpy()
    return ((a >> 32) & M32).astype(np.uint32), (a & M32).astype(np.uint32)


def _port_batch(seqs, cumlens, batch, S_cap):
    words, starts, nv, left, base, hap = state.batch_tensors(
        *pack_batch(seqs, cumlens, batch, ROW_LANES, S_cap), "cpu")
    nd = tk.delta_plane(starts, ROW_LANES)
    return (tk.unpack_2bit(words, ROW_LANES), nd, nv, left,
            tk.block_node_offsets(nd, base, SB))


@pytest.mark.parametrize("k,w,case", [
    pytest.param(35, 25, None, id="35-25"),
    pytest.param(47, 9, None, id="47-9"),
    pytest.param(63, 11, None, id="63-11"),
    pytest.param(35, 25, "ties", id="35-25-ties"),
    pytest.param(35, 25, "edges", id="35-25-edges"),
    pytest.param(40, 1, None, id="40-1"),
    pytest.param(63, 67, None, id="63-67")])
def test_rows3w_twin_matches_pallas(k, w, case):
    seqs, cumlens = _edge_walks(k, w, case)
    C = tk.block_cap(w)
    batches, S_cap = _batches(seqs, cumlens, k, w)
    carry = jnp.zeros(5, jnp.uint32)
    saw_cont = False
    for batch in batches:
        words, starts, nv, cont, base, _ = _ref_packed(seqs, cumlens, batch,
                                                       S_cap)
        *ref, carry = _ref_sketch_w(
            jnp.asarray(_ref_codes(words)),
            jk._delta_plane(jnp.asarray(starts), R, ROW_LANES),
            jnp.asarray(nv), jnp.asarray(cont), jnp.asarray(base), carry,
            k=k, w=w, n_rows=R, n_blocks=SB, C=C, interpret=True)
        hi, lo, se, cnt = tk.sketch_rows3w(
            *_port_batch(seqs, cumlens, batch, S_cap), k, w, C)
        got = _words(hi) + _words(lo) + (se.numpy(), cnt.numpy())
        for name, a, b in zip(("w3", "w2", "w1", "w0", "se", "cnt"), got,
                              ref):
            assert np.array_equal(a, np.asarray(b).astype(a.dtype)), name
        saw_cont |= bool(cont[0])
    assert saw_cont


def test_rows3w_twin_checks_k():
    codes = torch.zeros((1, ROW_LANES), dtype=torch.uint8)
    one = torch.zeros(1, dtype=torch.int32)
    off = torch.zeros((1, SB), dtype=torch.int32)
    with pytest.raises(ValueError, match="32 <= k <= 63"):
        tk.sketch_rows3w(codes, codes, one, one, off, 31, 11, 256)
    with pytest.raises(ValueError, match="1 <= k <= 31"):
        tk.sketch_rows3(codes, codes, one, one, off, 35, 11, 256)


def test_fold128_64_matches_numpy():
    rng = np.random.default_rng(7)
    hi = rng.integers(0, 1 << 64, 4096, dtype=np.uint64)
    lo = rng.integers(0, 1 << 64, 4096, dtype=np.uint64)
    hi[:3] = [0, (1 << 62) - 1, (1 << 64) - 1]
    lo[:3] = [0, (1 << 63), (1 << 64) - 1]
    want = fold128_64_np(hi, lo)
    got = tk.fold128_64(torch.from_numpy(hi.view(np.int64)),
                        torch.from_numpy(lo.view(np.int64)))
    assert np.array_equal(got.numpy().view(np.uint64), want)
    # and the reference's u32-limb emulation on the same keys
    w = [jnp.asarray(((x >> np.uint64(s)) & np.uint64(M32)).astype(np.uint32))
         for x, s in ((hi, 32), (hi, 0), (lo, 32), (lo, 0))]
    fh, fl = jk.fold128_64_u32(*w)
    assert np.array_equal(_words(got)[0], np.asarray(fh))
    assert np.array_equal(_words(got)[1], np.asarray(fl))


def _reads(seqs, rng, n_hit=300, n_miss=100):
    parts = [seqs[0][s:s + 150] for s in rng.integers(0, len(seqs[0]) - 160,
                                                      n_hit)]
    parts += [rng.integers(0, 4, 150).astype(np.uint8)
              for _ in range(n_miss)]
    return parts


def _oracle_spectrum(parts, k, w):
    """Folded window minima of the 126-bit canonical k-mers of each read,
    in Python integers (the spectrum is a set, so no dedup is needed)."""
    keys = set()
    for p in parts:
        km = []
        for i in range(len(p) - k + 1):
            f = rc = 0
            for j, c in enumerate(p[i:i + k].tolist()):
                f = (f << 2) | c
                rc |= (3 - c) << (2 * j)
            km.append(min(f, rc))
        keys.update(min(km[i:i + w]) for i in range(len(km) - w + 1))
    keys = sorted(keys)
    hi = np.array([x >> 64 for x in keys], np.uint64)
    lo = np.array([x & ((1 << 64) - 1) for x in keys], np.uint64)
    return np.unique(fold128_64_np(hi, lo))


def test_read_spectrum_k35_matches_jax(tmp_path):
    """The port's read spectrum against the reference pipeline's own call
    (sketch_read_concat; sketch_read_batch runs the 2-word device sketch,
    which holds only k <= 31) and a Python-integer oracle."""
    from phi_tpu.io.reads import load_read_batch
    from phi_tpu.sketch.minimizer import sketch_read_concat
    from phi_tpu_torch.pipeline import read_spectrum
    rng = np.random.default_rng(11)
    seqs, _ = _instance(11, [20_000])
    parts = _reads(seqs, rng, 40, 10) + [rng.integers(0, 4, 40)]
    path = tmp_path / "reads.fa"
    path.write_text("".join(f">r{i}\n{''.join('ACGT'[c] for c in p)}\n"
                            for i, p in enumerate(parts)))
    reads = load_read_batch(str(path))
    got = read_spectrum(reads, 35, 25)
    want = sketch_read_concat(reads.concat, reads.off, 35, 25)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    key = (got[0].astype(np.uint64) << np.uint64(32)) | got[1]
    assert len(key) > 200
    assert np.array_equal(key, _oracle_spectrum(parts, 35, 25))


def test_join_rows3w_matches_pallas():
    from phi_tpu import native
    k, w = 35, 11
    seqs, cumlens = _instance(3, [40_000, 7_000, 18_000])
    rng = np.random.default_rng(4)
    parts = _reads(seqs, rng)
    concat = np.concatenate(parts)
    off = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
    uniq = np.unique(native.spectrum_native(concat, off, k, w))
    sp_hi = (uniq >> np.uint64(32)).astype(np.uint32)
    sp_lo = (uniq & np.uint64(M32)).astype(np.uint32)
    ck = make_cuckoo(sp_hi, sp_lo)
    Thi, Tlo, Tid, seed, _ = ck
    tkey, tid, tseed = state.cuckoo_tensors(ck, "cpu")
    C = tk.block_cap(w)
    cap_total = tk.hit_cap(w, SB, R)
    batches, S_cap = _batches(seqs, cumlens, k, w)
    carry = jnp.zeros(5, jnp.uint32)
    hits = 0
    for batch in batches:
        words, starts, nv, cont, base, hap = _ref_packed(seqs, cumlens,
                                                         batch, S_cap)
        ref = jk._pallas_join_rows3w_ck(
            jnp.asarray(words), jnp.asarray(starts), jnp.asarray(nv),
            jnp.asarray(cont), jnp.asarray(base), jnp.asarray(hap), carry,
            jnp.asarray(Thi), jnp.asarray(Tlo), jnp.asarray(Tid),
            jnp.uint32(seed), k=k, w=w, n_rows=R, n_blocks=SB, C=C,
            cap_total=cap_total, interpret=True)
        carry = ref[5]
        got = tk.join_rows3w(
            *state.batch_tensors(*pack_batch(seqs, cumlens, batch,
                                             ROW_LANES, S_cap), "cpu"),
            tkey, tid, tseed, k, w, SB, C, cap_total)
        n_min, n_hit, f_se, f_id, f_hap, cnt_max = (x.numpy() for x in got)
        n = int(n_hit.sum())
        assert np.array_equal(n_min, np.asarray(ref[0]))
        assert np.array_equal(n_hit, np.asarray(ref[1]))
        assert np.array_equal(f_se[:n], np.asarray(ref[2])[:n])
        assert np.array_equal(f_id[:n], np.asarray(ref[3])[:n])
        assert np.array_equal(f_hap[:n], np.asarray(ref[4])[:n])
        assert np.array_equal(cnt_max, np.asarray(ref[6]))
        hits += n
    assert hits > 0


def _spectrum_wide(reads, k, w):
    """The read spectrum as the reference pipeline takes it at k > 31."""
    from phi_tpu.io.gfa import encode_seq
    from phi_tpu.sketch.minimizer import sketch_read_concat
    parts = [encode_seq(r) for r in reads]
    off = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
    return sketch_read_concat(np.concatenate(parts), off, k, w)


def test_wide_route_matches_jax(tmp_path, monkeypatch):
    k, w = 35, 9
    graph, reads = _graph_instance(tmp_path)
    from test_torch_rows2 import _spy
    calls = _spy(monkeypatch, "join_rows3w")
    occ = _compare(graph, _spectrum_wide(reads, k, w), k, w, 1.0, 2)
    assert occ.n_occ > 0
    assert calls


def test_pipeline_k35_matches_jax(tmp_path, jax_device_path, monkeypatch):
    from phi_tpu.config import Options as JaxOptions
    from phi_tpu_torch.config import Options
    from phi_tpu_torch.pipeline import run_pipeline
    gfa_path, reads_path = _mosaic(tmp_path)
    opt = dict(k=35, w=25, recombination=5.0)
    want = jax_device_path(gfa_path, reads_path, str(tmp_path / "jax.fa"),
                           JaxOptions(**opt))
    before = tk.sketch_rows3w.launches
    got = run_pipeline(gfa_path, reads_path, str(tmp_path / "torch.fa"),
                       Options(**opt), device="cpu")
    assert tk.sketch_rows3w.launches == before  # CPU tensors: the twin
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
    assert got.anchors.n_model_kmers > 0
    assert got.anchors.filtered_kmers == want.anchors.filtered_kmers


def _dense_chop(tmp_path):
    """A 3-haplotype graph chopped into 1-3 bp nodes: more than one node
    start per 4 bases, so the reference leaves v3 for the dense plane."""
    from phi_tpu.eval.synth import sample_reads, synth_pangenome
    from phi_tpu.io.gfa import write_gfa
    rng = np.random.default_rng(5)
    gfa_data, hap_seqs = synth_pangenome(rng, length=12_000, n_haps=3,
                                         max_node_len=3)
    path = str(tmp_path / "dense.gfa")
    write_gfa(gfa_data, path=path)
    reads, _ = sample_reads(rng, hap_seqs, coverage=2.0, read_len=120,
                            error_rate=0.002)
    return _graphs(path), reads


def test_wide_refusals_name_their_condition(tmp_path, monkeypatch,
                                            capsys):
    """k > 31 has no v2 kernel: with a dense chop or an oversized spectrum
    both packages return None (the host hit path), and the port names the
    condition."""
    import phi_tpu.ops.search as js
    import phi_tpu_torch.ops.search as ts
    (jgraph, graph), reads = _dense_chop(tmp_path)
    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    sp = _spectrum_wide(reads, 35, 9)

    def both(sb):
        want = jax_join(jgraph, seqs, 35, 9, sp[0], sp[1], 1.0,
                        rows_per_call=R, super_blocks=sb, interpret=True)
        got = join_anchors_device(graph, seqs, 35, 9, sp[0], sp[1], 1.0,
                                  device="cpu", rows_per_call=R,
                                  super_blocks=sb)
        return want, got

    assert both(1) == (None, None)
    assert "dense node chop" in capsys.readouterr().err
    monkeypatch.setattr(js, "CUCKOO_MAX_KEYS", 10)
    monkeypatch.setattr(ts, "CUCKOO_MAX_KEYS", 10)
    assert both(SB) == (None, None)
    assert "does not fit the cuckoo table; host hit path" in \
        capsys.readouterr().err


def test_overflow_refusals_name_their_condition(tmp_path, monkeypatch,
                                                capsys):
    """A block compaction overflow: both packages return None."""
    import phi_tpu_torch.anchors.device as tdev
    (jgraph, graph), reads = _graph_instance(tmp_path)
    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    sp = _spectrum_wide(reads, 35, 9)
    monkeypatch.setattr(jk, "block_cap", lambda w: 16)
    monkeypatch.setattr(tdev, "block_cap", lambda w: 16)
    assert jax_join(jgraph, seqs, 35, 9, sp[0], sp[1], 1.0,
                    rows_per_call=R, super_blocks=SB, interpret=True) is None
    assert join_anchors_device(graph, seqs, 35, 9, sp[0], sp[1], 1.0,
                               device="cpu", rows_per_call=R,
                               super_blocks=SB) is None
    err = capsys.readouterr().err
    assert "block compaction overflow" in err
    assert "> C=16); host hit path" in err
