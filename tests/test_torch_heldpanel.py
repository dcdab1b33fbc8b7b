"""The held panel (graph/pangenome.py): run_pipeline keeps the graph it
loaded, keyed by its file's identity, and a later run against the
unchanged file takes that very graph.

- a second run on one GFA counts a hit, takes the first run's graph, and
  its FASTA, recombination report, bound and objective equal a run after
  clear_caches();
- the GFA rewritten at the same path (with a new mtime) counts a drop and
  a load, and gives the new graph's answer;
- two samples back to back on the held panel each equal a run on a newly
  loaded graph, on the device anchors and on the hit path (whose anchors
  are materialized, so the sample-keyed memos on the graph are read), and
  a --load-index re-solve at another R takes the held panel;
- on a hit the load_graph spans keep their keys;
- clear_caches() drops the slot and counts a drop; cache_counts() holds
  "panel";
- a GFA that fails the pipeline's checks is never held, and a file that
  cannot be stat'ed has no key."""

import os

import numpy as np
import pytest

from phi_tpu_torch.config import Options
from phi_tpu_torch.eval import onchip
from phi_tpu_torch.eval.synth import sample_reads, synth_pangenome
from phi_tpu_torch.graph import pangenome
from phi_tpu_torch.io.gfa import write_gfa
from phi_tpu_torch.pipeline import run_pipeline

K, W, R = 21, 11, 5.0


@pytest.fixture(autouse=True)
def cold_caches():
    onchip.clear_caches()
    yield
    onchip.clear_caches()


def _panel(seed, length=6000, n_haps=4):
    rng = np.random.default_rng(seed)
    gfa_data, haps = synth_pangenome(rng, length=length, n_haps=n_haps,
                                     indel_fraction=0.1)
    return gfa_data, haps


def _reads(path, haps, seed, breaks):
    rng = np.random.default_rng(seed)
    reads, _ = sample_reads(rng, haps, coverage=3.0, read_len=120,
                            error_rate=0.002, recomb_breaks=breaks)
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    return str(path)


def _case(tmp_path, seed=11):
    """(gfa path, reads path, the panel's haplotype sequences)."""
    gfa_data, haps = _panel(seed)
    gfa = str(tmp_path / "graph.gfa")
    write_gfa(gfa_data, path=gfa)
    reads = _reads(tmp_path / "reads.fa", haps, seed + 1,
                   [(2000, 2), (4100, 3)])
    return gfa, reads, haps


def _run(gfa, reads, out, **kw):
    kw = {"k": K, "w": W, "recombination": R, **kw}
    return run_pipeline(gfa, reads, str(out), Options(**kw), device="cpu")


def _answer(res, out):
    """What the benchmark's check compares: the FASTA's bytes, the
    recombination report, the bound and the objective (exactly)."""
    with open(out, "rb") as f:
        fasta = f.read()
    return (fasta, list(res.report_segments), res.recombination_count,
            float(res.decode.dp_objective), float(res.decode.true_objective),
            [list(map(int, s)) for s in res.decode.segments])


def _fresh(gfa, reads, out, **kw):
    """A run on a newly loaded graph, with every cross-run cache cold."""
    onchip.clear_caches()
    loads = pangenome.PANEL_CACHE_STATS["loads"]
    res = _run(gfa, reads, out, **kw)
    assert pangenome.PANEL_CACHE_STATS["loads"] == loads + 1
    return _answer(res, out)


def test_second_run_takes_the_held_graph(tmp_path):
    gfa, reads, _ = _case(tmp_path)
    s0 = dict(pangenome.PANEL_CACHE_STATS)
    r1 = _run(gfa, reads, tmp_path / "a.fa")
    s1 = dict(pangenome.PANEL_CACHE_STATS)
    assert s1 == {**s0, "loads": s0["loads"] + 1}
    r2 = _run(gfa, reads, tmp_path / "b.fa")
    assert pangenome.PANEL_CACHE_STATS == {**s1, "hits": s1["hits"] + 1}
    assert r2.graph is r1.graph
    got = _answer(r2, tmp_path / "b.fa")
    assert got == _answer(r1, tmp_path / "a.fa")
    assert got == _fresh(gfa, reads, tmp_path / "c.fa")


def test_rewritten_file_loads_the_new_graph(tmp_path):
    gfa, reads, _ = _case(tmp_path)
    r1 = _run(gfa, reads, tmp_path / "a.fa")
    st = os.stat(gfa)
    other, haps = _panel(23)
    write_gfa(other, path=gfa)
    os.utime(gfa, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    reads2 = _reads(tmp_path / "reads2.fa", haps, 24, [(3000, 1)])
    s0 = dict(pangenome.PANEL_CACHE_STATS)
    r2 = _run(gfa, reads2, tmp_path / "b.fa")
    assert pangenome.PANEL_CACHE_STATS == {
        **s0, "loads": s0["loads"] + 1, "drops": s0["drops"] + 1}
    assert r2.graph is not r1.graph
    assert r2.graph.n_vtx == other.n_vtx
    want = _fresh(gfa, reads2, tmp_path / "c.fa")
    assert _answer(r2, tmp_path / "b.fa") == want
    assert want != _answer(r1, tmp_path / "a.fa")


@pytest.mark.parametrize("route", ["device", "hit_path"])
def test_samples_back_to_back_equal_fresh_runs(tmp_path, route):
    """The hit path (--save-index) materializes the anchors, so the solve
    reads the graph's sample-keyed memos (_first_occ, _occ_sorder)."""
    gfa, reads_a, haps = _case(tmp_path)
    reads_b = _reads(tmp_path / "reads_b.fa", haps, 31, [(1500, 1),
                                                         (3500, 0)])
    kw = {"save_index": str(tmp_path / "idx.npz")} \
        if route == "hit_path" else {}
    held = []
    for name, reads in (("a", reads_a), ("b", reads_b), ("a2", reads_a)):
        res = _run(gfa, reads, tmp_path / f"{name}.fa", **kw)
        held.append((res.graph, _answer(res, tmp_path / f"{name}.fa")))
    assert held[0][0] is held[1][0] is held[2][0]
    if route == "hit_path":
        assert getattr(held[0][0], "_first_occ", None) is not None
    assert held[0][1] != held[1][1]
    assert held[2][1] == held[0][1]
    assert held[0][1] == _fresh(gfa, reads_a, tmp_path / "fa.fa", **kw)
    assert held[1][1] == _fresh(gfa, reads_b, tmp_path / "fb.fa", **kw)


def test_load_index_resolve_takes_the_held_graph(tmp_path):
    gfa, reads, _ = _case(tmp_path)
    idx = str(tmp_path / "idx.npz")
    r1 = _run(gfa, reads, tmp_path / "a.fa", save_index=idx)
    hits = pangenome.PANEL_CACHE_STATS["hits"]
    r2 = _run(gfa, None, tmp_path / "b.fa", load_index=idx,
              recombination=50.0)
    assert pangenome.PANEL_CACHE_STATS["hits"] == hits + 1
    assert r2.graph is r1.graph
    assert _answer(r2, tmp_path / "b.fa") == _fresh(
        gfa, None, tmp_path / "c.fa", load_index=idx, recombination=50.0)


def test_hit_keeps_the_load_graph_spans(tmp_path):
    gfa, reads, _ = _case(tmp_path)
    _run(gfa, reads, tmp_path / "a.fa")
    r2 = _run(gfa, reads, tmp_path / "b.fa")
    t = r2.timings
    for key in ("load_graph", "load_graph_parse", "load_graph_tensorize"):
        assert key in t and t[key] >= 0.0
    assert t["load_graph_parse"] + t["load_graph_tensorize"] \
        <= t["load_graph"]


def test_clear_caches_drops_the_panel(tmp_path):
    gfa, reads, _ = _case(tmp_path)
    _run(gfa, reads, tmp_path / "a.fa")
    before = onchip.cache_counts()
    assert set(before["panel"]) == {"hits", "loads", "drops"}
    onchip.clear_caches()
    delta = onchip.cache_delta(before, onchip.cache_counts())
    assert delta["panel"] == {"hits": 0, "loads": 0, "drops": 1}
    onchip.clear_caches()   # nothing held: no second drop
    assert onchip.cache_counts()["panel"]["drops"] == \
        before["panel"]["drops"] + 1
    r = _run(gfa, reads, tmp_path / "b.fa")
    delta = onchip.cache_delta(before, onchip.cache_counts())
    assert delta["panel"] == {"hits": 0, "loads": 1, "drops": 1}
    assert pangenome.held_panel(pangenome.panel_key(gfa)) is r.graph


def test_failing_graph_is_never_held(tmp_path):
    gfa, reads, _ = _case(tmp_path)
    _run(gfa, reads, tmp_path / "a.fa")
    no_walks = tmp_path / "nowalks.gfa"
    with open(gfa) as f:
        no_walks.write_text("".join(l for l in f if not l.startswith("W")))
    s0 = dict(pangenome.PANEL_CACHE_STATS)
    for _ in range(2):
        with pytest.raises(ValueError, match="no W-line"):
            _run(str(no_walks), reads, tmp_path / "b.fa")
    # the first failure dropped the held panel; neither was held
    assert pangenome.PANEL_CACHE_STATS == {**s0, "drops": s0["drops"] + 1}
    assert pangenome.panel_key(str(tmp_path / "missing.gfa")) is None
    assert pangenome.panel_key(str(tmp_path)) is None
