"""The port's host modules against phi_tpu's on the CPU.

- The host anchor tables of the hit path: the port's native
  `anchor_tables_from_hits` against phi_tpu's, and the port's numpy
  reference (`_anchor_tables_from_hits_py`) against its native call, on the
  same join hits.
- The copies the port keeps of phi_tpu's host modules: graph ingest,
  reads, the recombination report, the edit distance, the options and the
  synthetic instance generator give what phi_tpu's give.
- The port imports nothing of phi_tpu or jax: an AST walk over every
  module of the package and chip_smoke.py.
"""

import ast
import dataclasses
import gzip
import os

import numpy as np
import pytest

pytest.importorskip("jax")

from phi_tpu_torch.anchors.join import (  # noqa: E402
    _anchor_tables_from_hits_py, anchor_tables_from_hits)
from phi_tpu_torch.sketch.kernels import join_many  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _instance(tmp_path, n_haps=5, length=20_000, seed=4):
    from phi_tpu_torch.eval.synth import sample_reads, synth_pangenome
    from phi_tpu_torch.io.gfa import write_gfa
    rng = np.random.default_rng(seed)
    gfa_data, hap_seqs = synth_pangenome(rng, length=length, n_haps=n_haps,
                                         indel_fraction=0.1)
    reads, _ = sample_reads(rng, hap_seqs, coverage=2.0, read_len=150,
                            error_rate=0.002, recomb_breaks=[(7000, 1)])
    gfa_path, reads_path = str(tmp_path / "g.gfa"), str(tmp_path / "r.fa")
    write_gfa(gfa_data, path=gfa_path)
    with open(reads_path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    return gfa_path, reads_path


def _assert_same(a, b, where="") -> None:
    """Deep equality of the two packages' objects: dataclasses field by
    field (the port's memos, excluded from comparison, aside), arrays by
    value and dtype, lists item by item."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            if not f.compare:
                continue
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _port_graph_and_hits(tmp_path, k, w):
    from phi_tpu_torch.graph.pangenome import tensorize
    from phi_tpu_torch.io.gfa import read_gfa
    from phi_tpu_torch.io.reads import load_read_batch
    from phi_tpu_torch.pipeline import read_spectrum
    gfa_path, reads_path = _instance(tmp_path)
    graph = tensorize(read_gfa(gfa_path))
    sp_hi, sp_lo = read_spectrum(load_read_batch(reads_path), k, w)
    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    hits = join_many(seqs, k, w, sp_hi, sp_lo, device="cpu",
                     rows_per_call=2, super_blocks=2)
    return gfa_path, graph, hits, len(sp_hi)


@pytest.mark.parametrize("threshold", [1.0, 0.5])
def test_anchor_tables_from_hits_matches_jax(tmp_path, threshold):
    from phi_tpu.anchors.join import anchor_tables_from_hits as jax_tables
    from phi_tpu.graph import tensorize as jax_tensorize
    from phi_tpu.io.gfa import read_gfa as jax_read_gfa
    k, w = 15, 5
    gfa_path, graph, hits, n_sp = _port_graph_and_hits(tmp_path, k, w)
    got = anchor_tables_from_hits(graph, k, hits, n_sp, threshold)
    want = jax_tables(jax_tensorize(jax_read_gfa(gfa_path)), k, hits, n_sp,
                      threshold)
    _assert_same(got, want, "tables")
    assert len(got.occ_hap) > 0
    if threshold < 1.0:
        assert got.filtered_kmers > 0
    # the numpy reference kept beside the native call agrees with it
    _assert_same(_anchor_tables_from_hits_py(graph, k, hits, n_sp,
                                             threshold), got, "py")


def test_anchor_tables_from_hits_raises_on_unsorted_hits(tmp_path):
    """No fallback on the run path: hits out of position order raise."""
    k, w = 15, 5
    _, graph, hits, n_sp = _port_graph_and_hits(tmp_path, k, w)
    n_min, pos, ids = hits[1]
    hits[1] = (n_min, pos[::-1].copy(), ids[::-1].copy())
    with pytest.raises(RuntimeError, match="not ascending"):
        anchor_tables_from_hits(graph, k, hits, n_sp, 1.0)


def test_graph_and_reads_copies_match_jax(tmp_path):
    from phi_tpu.graph import tensorize as jax_tensorize
    from phi_tpu.io.gfa import read_gfa as jax_read_gfa
    from phi_tpu.io.reads import load_read_batch as jax_load_reads
    from phi_tpu_torch.graph.pangenome import tensorize
    from phi_tpu_torch.io.gfa import read_gfa
    from phi_tpu_torch.io.reads import load_read_batch
    gfa_path, reads_path = _instance(tmp_path)
    _assert_same(tensorize(read_gfa(gfa_path)),
                 jax_tensorize(jax_read_gfa(gfa_path)), "graph")
    got, want = load_read_batch(reads_path), jax_load_reads(reads_path)
    for f in ("lengths", "names", "concat", "off"):
        _assert_same(getattr(got, f), getattr(want, f), f)
    assert got.n_reads == want.n_reads > 0


def test_report_edits_options_copies_match_jax(tmp_path):
    from phi_tpu.config import Options as JaxOptions
    from phi_tpu.emit import recombination_report as jax_report
    from phi_tpu.eval.edits import edit_stats as jax_edit_stats
    from phi_tpu.graph import tensorize as jax_tensorize
    from phi_tpu.io.gfa import read_gfa as jax_read_gfa
    from phi_tpu_torch.config import Options
    from phi_tpu_torch.emit import recombination_report
    from phi_tpu_torch.eval import edit_stats
    from phi_tpu_torch.graph.pangenome import tensorize
    from phi_tpu_torch.io.gfa import read_gfa
    gfa_path, _ = _instance(tmp_path)
    graph = tensorize(read_gfa(gfa_path))
    jgraph = jax_tensorize(jax_read_gfa(gfa_path))
    rng = np.random.default_rng(2)
    # a path that switches haplotype at two walk positions of shared nodes
    H, P = graph.walk_mat.shape
    hap = np.zeros(graph.n_vtx, np.int32)
    verts = graph.walk_mat[0, :graph.walk_len[0]]
    for h0, at in ((1, 0.3), (3, 0.7)):
        hap[verts[int(at * len(verts)):]] = h0
    hap = hap[verts]
    _assert_same(recombination_report(graph, verts, hap),
                 jax_report(jgraph, verts, hap), "report")
    a = "".join("ACGT"[c] for c in rng.integers(0, 4, 3000))
    b = a[:1000] + "T" + a[1005:2500] + "GG" + a[2500:]
    _assert_same(edit_stats(a, b), jax_edit_stats(a, b), "edits")
    assert edit_stats(a, b).edit_distance > 0
    _assert_same(Options(), JaxOptions(), "options")


def test_build_instance_matches_jax(tmp_path, monkeypatch):
    """The same files from the same seed into the same directory names. The
    reads are gzip files whose headers hold the write time, so those are
    compared decompressed; every other file byte for byte."""
    import phi_tpu.eval.scale as jscale
    import phi_tpu_torch.eval.scale as tscale
    monkeypatch.setattr(jscale, "CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(tscale, "CACHE_DIR", str(tmp_path / "port"))
    want = jscale.build_instance(3, 30_000, coverage=1.0)
    got = tscale.build_instance(3, 30_000, coverage=1.0)
    assert sorted(got) == sorted(want)
    for key in want:
        assert os.path.relpath(got[key], tmp_path / "port") == \
            os.path.relpath(want[key], tmp_path / "jax")
        op = gzip.open if want[key].endswith(".gz") else open
        with op(want[key], "rb") as a, op(got[key], "rb") as b:
            assert a.read() == b.read(), key


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "phi_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_port_imports_nothing_of_phi_tpu_or_jax():
    """Every import statement, at top level or inside a function, of every
    port module and chip_smoke.py: no root `phi_tpu` or `jax`."""
    bad = []
    sources = _port_sources()
    assert len(sources) > 30
    rel = {os.path.relpath(p, REPO) for p in sources}
    assert {"phi_tpu_torch/vcfio/vcf2graph.py", "phi_tpu_torch/vcfio/__init__.py",
            "phi_tpu_torch/eval/frontier.py",
            "phi_tpu_torch/sketch/encode.py", "phi_tpu_torch/eval/stats.py",
            "phi_tpu_torch/eval/scrape.py", "phi_tpu_torch/eval/batch.py",
            "phi_tpu_torch/io/subset.py", "phi_tpu_torch/eval/baselines.py",
            "phi_tpu_torch/eval/crossval.py", "phi_tpu_torch/eval/scale.py",
            "phi_tpu_torch/eval/throughput.py",
            "phi_tpu_torch/parallel/__init__.py",
            "phi_tpu_torch/parallel/dist.py",
            "phi_tpu_torch/parallel/sharded.py",
            "phi_tpu_torch/eval/groundtruth.py",
            "phi_tpu_torch/eval/floor_diag.py",
            "phi_tpu_torch/eval/merge_gt.py", "phi_tpu_torch/eval/plots.py",
            "phi_tpu_torch/eval/datasets.py",
            "phi_tpu_torch/eval/competitors.py",
            "phi_tpu_torch/eval/mesh_trace.py"} <= rel
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("phi_tpu", "jax", "jaxlib"):
                    bad.append(f"{os.path.relpath(path, REPO)}:"
                               f"{node.lineno} {name}")
    assert not bad, bad
