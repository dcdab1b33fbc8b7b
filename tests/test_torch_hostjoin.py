"""The host hit path on the CPU: the port against phi_tpu.

- The join bindings (`native.hap_join_native`, `hap_join_walk_native`,
  `join_accel`, `pool_threads`) against the JAX package's, on seeded codes
  with N at k = 15, 31, 35 and 63, with and without the first-probe table.
- `sketch.minimizer.sketch_join_walks` against the JAX package's at k = 31
  and 35.
- The pipeline where the device anchors hand over to the hit path, against
  phi_tpu on its device path (which hands over at the same places): a walk
  holding N, 256 haplotypes, k = 35 off the cuckoo table, k = 31 w = 100
  (k + w - 2 beyond the kernels' halo), a small block capacity, and
  `--save-index` at k = 35 and with an N walk, each package loading the
  other's index. Each case gives a byte-identical FASTA and equal
  per-haplotype minimizer and anchor counts, n_model_kmers and
  filtered_kmers.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import phi_tpu.native as jnat  # noqa: E402
import phi_tpu.sketch.minimizer as jm  # noqa: E402
from phi_tpu.config import Options as JaxOptions  # noqa: E402
from phi_tpu.graph import tensorize as jax_tensorize  # noqa: E402
from phi_tpu.io.gfa import read_gfa as jax_read_gfa  # noqa: E402
from phi_tpu_torch import native  # noqa: E402
from phi_tpu_torch.config import Options  # noqa: E402
from phi_tpu_torch.eval.synth import sample_reads, synth_pangenome  # noqa: E402
from phi_tpu_torch.graph.pangenome import tensorize  # noqa: E402
from phi_tpu_torch.io.gfa import read_gfa, write_gfa  # noqa: E402
from phi_tpu_torch.pipeline import run_pipeline  # noqa: E402
from phi_tpu_torch.sketch import kernels as tk  # noqa: E402
from phi_tpu_torch.sketch import minimizer as tm  # noqa: E402


def _keys_of(codes, k, w, every=2):
    """Sorted spectrum keys: every other emitted minimizer key of 90 bp
    fragments of codes (folded 64-bit keys for k > 31), so joins hit."""
    frags = [codes[i:i + 90] for i in range(0, len(codes) - 90, 70)]
    off = np.concatenate([[0], np.cumsum([len(f) for f in frags])])
    keys = native.spectrum_native(np.concatenate(frags), off, k, w)
    rng = np.random.default_rng(k)
    noise = rng.integers(0, 1 << 62, 500, dtype=np.int64).astype(np.uint64)
    return np.unique(np.concatenate([keys[::every], noise]))


def _codes_with_n(seed, n=30_000):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    for at in rng.integers(0, n - 80, 8):
        codes[at:at + rng.integers(1, 70)] = 4
    return codes


def _same_hits(got, want):
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[1].dtype == np.int32 and got[2].dtype == np.int32


@pytest.mark.parametrize("accel", [False, True], ids=["search", "accel"])
@pytest.mark.parametrize("k", [15, 31, 35, 63])
def test_join_bindings_match_jax(k, accel):
    w = 11
    codes = _codes_with_n(k)
    sp_key = _keys_of(codes, k, w)
    acc = native.join_accel(sp_key) if accel else None
    if accel:
        want_acc = jnat.join_accel(sp_key)
        np.testing.assert_array_equal(acc[0], want_acc[0])
        assert acc[1] == want_acc[1]
    got = native.hap_join_native(codes, k, w, sp_key, acc)
    _same_hits(got, jnat.hap_join_native(codes, k, w, sp_key, acc))
    assert got[0] > 0 and len(got[1]) > 0
    # the same bases as a walk of 1-40 bp nodes, in shuffled node order
    rng = np.random.default_rng(k + 1)
    cuts = np.unique(rng.integers(1, len(codes), len(codes) // 20))
    node_off = np.concatenate([[0], cuts, [len(codes)]]).astype(np.int64)
    perm = rng.permutation(len(node_off) - 1)
    seq_code = np.concatenate([codes[node_off[v]:node_off[v + 1]]
                               for v in perm])
    shuffled_off = np.concatenate(
        [[0], np.cumsum(np.diff(node_off)[perm])]).astype(np.int64)
    walk = np.argsort(perm).astype(np.int32)
    got_w = native.hap_join_walk_native(seq_code, shuffled_off, walk,
                                        len(codes), k, w, sp_key, acc)
    _same_hits(got_w, jnat.hap_join_walk_native(
        seq_code, shuffled_off, walk, len(codes), k, w, sp_key, acc))
    _same_hits(got_w, got)


def test_pool_threads_follow_set_threads(monkeypatch):
    monkeypatch.setattr(native, "THREADS", 0)
    monkeypatch.setattr(jnat, "THREADS", 0)
    assert native.pool_threads() == jnat.pool_threads()
    native.set_threads(3)
    try:
        assert native.pool_threads() == 3
    finally:
        native.set_threads(0)


def _write(d, gfa_data, reads):
    gfa_path, reads_path = str(d / "graph.gfa"), str(d / "reads.fa")
    write_gfa(gfa_data, path=gfa_path)
    with open(reads_path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    return gfa_path, reads_path


def _mosaic(d, n_haps=4, length=7000, n_node=None, seed=11, read_len=120):
    """A synthetic mosaic; with n_node, an N run written into that node's
    sequence (on walk 0; N is not in the reads)."""
    rng = np.random.default_rng(seed)
    gfa_data, hap_seqs = synth_pangenome(rng, length=length, n_haps=n_haps,
                                         indel_fraction=0.1)
    reads, _ = sample_reads(rng, hap_seqs[:3], coverage=3.0,
                            read_len=read_len,
                            error_rate=0.002,
                            recomb_breaks=[(length // 3, 1),
                                           (2 * length // 3, 2)])
    if n_node is not None:
        v = int(gfa_data.walks[0][n_node])
        lo, hi = gfa_data.node_off[v], gfa_data.node_off[v + 1]
        gfa_data.seq_code[lo + (hi - lo) // 4:hi - (hi - lo) // 4] = 4
    return _write(d, gfa_data, reads)


def test_sketch_join_walks_matches_jax(tmp_path):
    gfa_path, _ = _mosaic(tmp_path, n_node=40)
    graph = tensorize(read_gfa(gfa_path))
    jgraph = jax_tensorize(jax_read_gfa(gfa_path))
    assert (graph.walk_seq_codes(0) >= 4).any()
    for k in (31, 35):
        sp_key = _keys_of(graph.walk_seq_codes(1), k, 25, every=3)
        sp_hi = (sp_key >> np.uint64(32)).astype(np.uint32)
        sp_lo = (sp_key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        got = tm.sketch_join_walks(graph, k, 25, sp_hi, sp_lo)
        want = jm.sketch_join_walks(jgraph, k, 25, sp_hi, sp_lo)
        assert len(got) == len(want) == graph.num_walks
        for g, x in zip(got, want):
            _same_hits(g, x)
        assert all(len(g[1]) for g in got)
        for h in range(graph.num_walks):
            _same_hits(tm.host_join_one(graph.walk_seq_codes(h), k, 25,
                                        sp_hi, sp_lo), got[h])


@pytest.fixture
def jax_device_path(monkeypatch):
    """phi_tpu on its device path (interpret-mode Pallas, device solve), at
    a small row geometry, and the port's join_many at the same geometry:
    results do not depend on it."""
    import phi_tpu.sketch.kernels as jk
    from phi_tpu_torch.anchors import device as tdev
    monkeypatch.setenv("PHI_TPU_FORCE_DEVICE_ANCHORS", "1")
    monkeypatch.setenv("PHI_TPU_FORCE_DEVICE_SOLVE", "1")
    for mod in (jk, tk, tdev):
        monkeypatch.setattr(mod, "ROWS", 2)
        monkeypatch.setattr(mod, "SUPER_BLOCKS", 2)
    from phi_tpu.pipeline import run_pipeline as jax_run
    return jax_run


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _match(got, want, got_fa, want_fa):
    assert _read(got_fa) == _read(want_fa)
    assert got.recombination_count == want.recombination_count
    assert got.report_segments == want.report_segments
    a, b = got.anchors, want.anchors
    np.testing.assert_array_equal(a.per_hap_minimizers, b.per_hap_minimizers)
    np.testing.assert_array_equal(a.per_hap_anchors, b.per_hap_anchors)
    assert a.n_model_kmers == b.n_model_kmers
    assert a.n_model_kmers > 0
    assert a.filtered_kmers == b.filtered_kmers
    assert got.decode.true_objective == pytest.approx(
        want.decode.true_objective, abs=1e-3)


def _run_both(tmp_path, jax_run, gfa_path, reads_path, **kw):
    want = jax_run(gfa_path, reads_path, str(tmp_path / "jax.fa"),
                   JaxOptions(**kw))
    got = run_pipeline(gfa_path, reads_path, str(tmp_path / "port.fa"),
                       Options(**kw), device="cpu")
    _match(got, want, tmp_path / "port.fa", tmp_path / "jax.fa")
    assert got.anchors.device_occ is None  # the hit path ran
    return got


def _spy(monkeypatch, mod, name):
    fn = getattr(mod, name)
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(mod, name, counted)
    return calls


def _tiny_panel(d, n_haps=256):
    """A 600 bp graph with 256 walks (more than the u8 hap column holds)."""
    rng = np.random.default_rng(4)
    gfa_data, hap_seqs = synth_pangenome(rng, length=600, n_haps=n_haps,
                                         var_rate=0.03)
    reads, _ = sample_reads(rng, hap_seqs[:2], coverage=6.0, read_len=100,
                            error_rate=0.0, recomb_breaks=[(300, 1)])
    return _write(d, gfa_data, reads)


def test_n_walk_takes_join_many_and_the_host_join(tmp_path, jax_device_path,
                                                  monkeypatch, capsys):
    from phi_tpu_torch import pipeline
    gfa_path, reads_path = _mosaic(tmp_path, n_node=40)
    joins = _spy(monkeypatch, pipeline, "join_many")
    host = _spy(monkeypatch, pipeline, "host_join_many")
    walks = _spy(monkeypatch, pipeline, "sketch_join_walks")
    _run_both(tmp_path, jax_device_path, gfa_path, reads_path,
              recombination=5.0)
    assert joins and host and not walks
    assert "walk 0 contains non-ACGT bases; host hit path" in \
        capsys.readouterr().err


def test_256_haplotypes(tmp_path, jax_device_path, capsys):
    gfa_path, reads_path = _tiny_panel(tmp_path)
    _run_both(tmp_path, jax_device_path, gfa_path, reads_path, k=15, w=5,
              recombination=5.0)
    assert "256 haplotypes > 255" in capsys.readouterr().err


def test_k35_off_the_cuckoo_table(tmp_path, jax_device_path, monkeypatch,
                                  capsys):
    import phi_tpu.ops.search as js
    import phi_tpu_torch.ops.search as ts
    from phi_tpu_torch import pipeline
    monkeypatch.setattr(js, "CUCKOO_MAX_KEYS", 100)
    monkeypatch.setattr(ts, "CUCKOO_MAX_KEYS", 100)
    walks = _spy(monkeypatch, pipeline, "sketch_join_walks")
    gfa_path, reads_path = _mosaic(tmp_path)
    _run_both(tmp_path, jax_device_path, gfa_path, reads_path, k=35, w=25,
              recombination=5.0)
    assert walks
    assert "does not fit the cuckoo table; host hit path" in \
        capsys.readouterr().err


def test_k31_w100_runs_as_the_reference(tmp_path, jax_device_path,
                                        monkeypatch, capsys):
    """k + w - 2 = 129 > 128: the fault of the earlier port (a ValueError
    and no FASTA) is gone; both packages join on the host."""
    from phi_tpu_torch import pipeline
    walks = _spy(monkeypatch, pipeline, "sketch_join_walks")
    launches = tk.sketch_rows.launches
    gfa_path, reads_path = _mosaic(tmp_path, read_len=400)
    _run_both(tmp_path, jax_device_path, gfa_path, reads_path, k=31, w=100,
              recombination=5.0)
    assert walks and tk.sketch_rows.launches == launches
    assert "k + w - 2 = 129 > 128" in capsys.readouterr().err


def test_small_block_cap(tmp_path, jax_device_path, monkeypatch, capsys):
    import phi_tpu.sketch.kernels as jk
    from phi_tpu_torch.anchors import device as tdev
    monkeypatch.setattr(jk, "block_cap", lambda w: 16)
    monkeypatch.setattr(tdev, "block_cap", lambda w: 16)
    gfa_path, reads_path = _mosaic(tmp_path)
    _run_both(tmp_path, jax_device_path, gfa_path, reads_path,
              recombination=5.0)
    assert "block compaction overflow" in capsys.readouterr().err


def _arrays(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("case", ["k35", "n_walk"])
def test_save_index_loads_across_packages(tmp_path, jax_device_path, case):
    gfa_path, reads_path = _mosaic(tmp_path,
                                   n_node=40 if case == "n_walk" else None)
    kw = dict(k=35, w=25) if case == "k35" else dict(k=21, w=11)
    idx = {p: str(tmp_path / f"{p}.npz") for p in ("jax", "port")}
    want = jax_device_path(gfa_path, reads_path, str(tmp_path / "jax.fa"),
                           JaxOptions(recombination=5.0, save_index=idx["jax"],
                                      **kw))
    got = run_pipeline(gfa_path, reads_path, str(tmp_path / "port.fa"),
                       Options(recombination=5.0, save_index=idx["port"],
                               **kw), device="cpu")
    _match(got, want, tmp_path / "port.fa", tmp_path / "jax.fa")
    a, b = _arrays(idx["jax"]), _arrays(idx["port"])
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    # each package re-solves from the other's index
    want2 = jax_device_path(gfa_path, None, str(tmp_path / "jax2.fa"),
                            JaxOptions(recombination=2.0,
                                       load_index=idx["port"], **kw))
    got2 = run_pipeline(gfa_path, None, str(tmp_path / "port2.fa"),
                        Options(recombination=2.0, load_index=idx["jax"],
                                **kw), device="cpu")
    assert _read(tmp_path / "jax2.fa").split(b"\n")[1:] == \
        _read(tmp_path / "port2.fa").split(b"\n")[1:]
    assert got2.report_segments == want2.report_segments
