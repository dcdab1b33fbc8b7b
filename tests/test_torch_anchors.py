"""Device anchor pipeline parity: the port's join_anchors_device (CPU
tensors, plain twins) against phi_tpu's join_anchors_device (Pallas in
interpret mode) on the same graph and spectrum: equal minimizer counts,
filter stats and retained occurrences, in the same order."""

import numpy as np
import pytest

pytest.importorskip("jax")

from phi_tpu.anchors.device import join_anchors_device as jax_join  # noqa: E402
from phi_tpu.graph import tensorize  # noqa: E402
from phi_tpu.io.gfa import encode_seq, read_gfa  # noqa: E402
from phi_tpu.sketch.minimizer import sketch_read_batch  # noqa: E402
from phi_tpu_torch.anchors.device import join_anchors_device  # noqa: E402
from phi_tpu_torch.graph.pangenome import tensorize as port_tensorize  # noqa: E402
from phi_tpu_torch.io.gfa import read_gfa as port_read_gfa  # noqa: E402


def _graphs(path):
    """The same GFA as each package's own graph: (phi_tpu's, the port's)."""
    return tensorize(read_gfa(path)), port_tensorize(port_read_gfa(path))


def _instance(tmp_path, n_haps=6, length=9000, seed=0):
    from phi_tpu.eval.synth import sample_reads, synth_pangenome
    from phi_tpu.io.gfa import write_gfa
    rng = np.random.default_rng(seed)
    gfa_path = str(tmp_path / "g.gfa")
    gfa_data, hap_seqs = synth_pangenome(rng, length=length, n_haps=n_haps,
                                         indel_fraction=0.1)
    write_gfa(gfa_data, path=gfa_path)
    reads, _ = sample_reads(rng, hap_seqs[:2], coverage=1.5, read_len=120,
                            error_rate=0.002, recomb_breaks=[(4000, 1)])
    return _graphs(gfa_path), reads


def _spectrum(reads, k, w):
    rc = np.full((len(reads), max(len(r) for r in reads)), 4, np.uint8)
    ln = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        rc[i, :len(r)] = encode_seq(r)
        ln[i] = len(r)
    return sketch_read_batch(rc, k, w, ln)


def _compare(graphs, spectrum, k, w, threshold, sb):
    jgraph, graph = graphs
    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    want = jax_join(jgraph, seqs, k, w, spectrum[0], spectrum[1], threshold,
                    rows_per_call=2, super_blocks=sb, interpret=True)
    assert want is not None
    got_min, got = join_anchors_device(
        graph, seqs, k, w, spectrum[0], spectrum[1], threshold,
        device="cpu", rows_per_call=2, super_blocks=sb)
    want_min, want_occ = want
    assert np.array_equal(got_min, want_min)
    assert got.n_occ == want_occ.n_occ
    assert got.n_model == want_occ.n_model
    assert got.filtered == want_occ.filtered
    assert got.max_span == want_occ.max_span
    assert np.array_equal(got.per_hap_anchors, want_occ.per_hap_anchors)
    for a, b in zip(got.materialize(), want_occ.materialize()):
        assert np.array_equal(a, b)
    return got


@pytest.mark.parametrize("threshold", [1.0, 0.5])
def test_device_anchors_match_jax(tmp_path, threshold):
    k, w = 21, 11
    graph, reads = _instance(tmp_path)
    occ = _compare(graph, _spectrum(reads, k, w), k, w, threshold, 2)
    assert occ.n_occ > 0
    if threshold == 0.5:
        assert occ.filtered > 0


def test_device_anchors_zero_len_nodes(tmp_path):
    """A diamond with an empty deletion arm: node starts stack at one base
    and interval ends must count the zero-length node."""
    gfa = tmp_path / "z.gfa"
    seg_a = "ACGTACGTAGCTTACGGATC"
    seg_b = "TTGCA"
    seg_c = "GGATCCATTGCAAGGTCCAA"
    gfa.write_text(
        "H\tVN:Z:1.1\n"
        f"S\ts1\t{seg_a}\nS\ts2\t{seg_b}\nS\ts3\t\nS\ts4\t{seg_c}\n"
        "L\ts1\t+\ts2\t+\t0M\nL\ts1\t+\ts3\t+\t0M\n"
        "L\ts2\t+\ts4\t+\t0M\nL\ts3\t+\ts4\t+\t0M\n"
        "W\tsamp\t1\tchr\t0\t45\t>s1>s2>s4\n"
        "W\tsamp\t2\tchr\t0\t40\t>s1>s3>s4\n")
    graph = _graphs(str(gfa))
    k, w = 9, 4
    spectrum = _spectrum([seg_a + seg_b + seg_c, seg_a + seg_c], k, w)
    occ = _compare(graph, spectrum, k, w, 1.0, 1)
    assert occ.n_occ > 0


def test_n_walk_raises(tmp_path, capsys):
    """Walks with N leave the device anchors for the host hit path: the
    port returns None where phi_tpu does, and says why."""
    gfa = tmp_path / "n.gfa"
    gfa.write_text("H\tVN:Z:1.1\nS\ts1\tACGTNACGTACGTTGCA\n"
                   "W\tsamp\t1\tchr\t0\t17\t>s1\n")
    jgraph, graph = _graphs(str(gfa))
    seqs = [graph.walk_seq_codes(0)]
    sp = _spectrum(["ACGTACGTTGCA"], 5, 2)
    assert jax_join(jgraph, seqs, 5, 2, sp[0], sp[1], 1.0,
                    interpret=True) is None
    assert join_anchors_device(graph, seqs, 5, 2, sp[0], sp[1], 1.0,
                               device="cpu") is None
    assert "walk 0 contains non-ACGT bases; host hit path" in \
        capsys.readouterr().err


@pytest.mark.parametrize("threshold", [1.0, 0.5])
def test_chunked_finalize_matches_one_chunk_and_jax(tmp_path, monkeypatch,
                                                    threshold):
    """The filter in chunks of 4096 hits (PHI_TPU_FIN_CHUNK, read by both
    packages): more than one chunk, and the DeviceOcc columns, in order,
    equal to one chunk's and to phi_tpu's chunked filter (the counterpart
    of tests/test_device_anchors.py::test_device_anchor_chunked_finalize)."""
    k, w = 21, 11
    graph, reads = _instance(tmp_path, n_haps=5, length=12000)
    spectrum = _spectrum(reads, k, w)
    seqs = [graph[1].walk_seq_codes(h) for h in range(graph[1].num_walks)]
    _, one = join_anchors_device(graph[1], seqs, k, w, spectrum[0],
                                 spectrum[1], threshold, device="cpu",
                                 rows_per_call=2, super_blocks=2)
    assert one.n_chunks == 1
    monkeypatch.setenv("PHI_TPU_FIN_CHUNK", "4096")
    got = _compare(graph, spectrum, k, w, threshold, 2)
    assert got.n_hits > 4096 and got.n_chunks == -(-got.n_hits // 4096) > 1
    for a, b in zip(got.materialize(), one.materialize()):
        assert np.array_equal(a, b)
    assert (got.n_occ, got.n_model, got.filtered, got.max_span) == \
        (one.n_occ, one.n_model, one.filtered, one.max_span)
    assert np.array_equal(got.per_hap_anchors, one.per_hap_anchors)
