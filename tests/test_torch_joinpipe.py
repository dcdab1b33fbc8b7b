"""The join pipelines and the cross-run device caches on the CPU, through
the plain twins:

- join_anchors_device with 1, 2 and 3 pack workers, on a cache miss and
  on a cache hit, against phi_tpu's join_anchors_device in interpret
  mode: per_hap_min and the occurrence columns equal (5 batches, not a
  multiple of the window);
- join_many at several batch counts around the window and with a forced
  overflow retry, against pallas_join_many: equal (n_min, positions, ids);
- a second run on a re-loaded graph (the held panel dropped) hits the
  packed-batch slot, the device cache and the switch-source slot, with
  equal arrays and the same FASTA bytes; the solver statics are uploaded
  once per ladder;
- the slot's key holds the node segmentation (the JAX fingerprint does
  not), and a run that does not cache empties the slot;
- _dev_cached keeps at most 12 keys and no content key above its gate,
  and walk_mat's hashes stay cached only below it;
- a raising pack worker's exception reaches the caller;
- the joins' spans hold the stages the JAX package's profiler lines
  time."""

import re

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from phi_tpu.anchors import device as jdev  # noqa: E402
from phi_tpu.sketch import kernels as jk  # noqa: E402
from phi_tpu_torch import pipeline, state  # noqa: E402
from phi_tpu_torch.anchors import device as dv  # noqa: E402
from phi_tpu_torch.config import Options  # noqa: E402
from phi_tpu_torch.eval.hbm_budget import budget_of_run  # noqa: E402
from phi_tpu_torch.eval.onchip import clear_caches  # noqa: E402
from phi_tpu_torch.graph.pangenome import clear_panel  # noqa: E402
from phi_tpu_torch.sketch import kernels as tk  # noqa: E402
from phi_tpu_torch.solve import dp, prep  # noqa: E402
from tests.test_torch_anchors import _instance, _spectrum  # noqa: E402
from tests.test_torch_pipeline import _mosaic, _refinement  # noqa: E402
from tests.test_torch_rows import (_assert_hits_equal, _many_seqs,  # noqa: E402
                                   _spectrum as _seq_spectrum)

K, W = 21, 11
# one block a row: 10 rows of 5 walks x 9,000 bp, 2 rows a batch
GEOM = dict(rows_per_call=2, super_blocks=1)


@pytest.fixture(autouse=True)
def cold_caches():
    clear_caches()
    yield
    clear_caches()


@pytest.fixture(scope="module")
def anchors_case(tmp_path_factory):
    """(phi_tpu's graph, the port's graph, seqs, spectrum, phi_tpu's
    result) on a 5-walk x 9,000 bp instance."""
    graphs, reads = _instance(tmp_path_factory.mktemp("g"), n_haps=5)
    jgraph, graph = graphs
    sp = _spectrum(reads, K, W)
    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    want = jdev.join_anchors_device(jgraph, seqs, K, W, sp[0], sp[1], 1.0,
                                    interpret=True, **GEOM)
    assert want is not None
    return jgraph, graph, seqs, sp, want


def _port_join(case, **kw):
    _, graph, seqs, sp, _ = case
    return dv.join_anchors_device(graph, seqs, K, W, sp[0], sp[1], 1.0,
                                  device="cpu", **{**GEOM, **kw})


def _assert_same(got, want_min, want_occ):
    got_min, occ = got
    assert np.array_equal(got_min, want_min)
    assert (occ.n_occ, occ.n_model, occ.filtered, occ.max_span) == \
        (want_occ.n_occ, want_occ.n_model, want_occ.filtered,
         want_occ.max_span)
    assert np.array_equal(occ.per_hap_anchors, want_occ.per_hap_anchors)
    for a, b in zip(occ.materialize(), want_occ.materialize()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("workers", ["1", "2", "3"])
def test_join_anchors_workers_and_slot_match_jax(anchors_case, monkeypatch,
                                                 workers):
    monkeypatch.setenv("PHI_TPU_PACK_WORKERS", workers)
    want_min, want_occ = anchors_case[4]
    rows = dv.plan_rows(anchors_case[2], K, W, GEOM["super_blocks"])
    n_batches = -(-len(rows) // GEOM["rows_per_call"])
    assert n_batches > dv.WINDOW and n_batches % dv.WINDOW
    stats = dict(dv.PACK_CACHE_STATS)
    miss = _port_join(anchors_case)
    assert dv.PACK_CACHE_STATS["stores"] == stats["stores"] + 1
    hit = _port_join(anchors_case)
    assert dv.PACK_CACHE_STATS["hits"] == stats["hits"] + 1
    for got in (miss, hit):
        _assert_same(got, want_min, want_occ)
    assert miss[1].pack_bytes == hit[1].pack_bytes == dv.pack_cache_bytes() > 0


@pytest.fixture(scope="module")
def many_case():
    k, w = 17, 9
    seqs = _many_seqs()
    sp_hi, sp_lo = _seq_spectrum([seqs[0], seqs[3]], k, w)
    want = jk.pallas_join_many(seqs, k, w, jnp.asarray(sp_hi),
                               jnp.asarray(sp_lo), rows_per_call=2,
                               super_blocks=2, interpret=True)
    return k, w, seqs, sp_hi, sp_lo, want


@pytest.mark.parametrize("rows_per_call", [1, 5, 7])
@pytest.mark.parametrize("retry", [False, True], ids=["caps", "retry"])
def test_join_many_window_and_retry_match_jax(many_case, monkeypatch,
                                              rows_per_call, retry):
    """1 row a batch: 12 batches; 5: 3, the window; 7: 2, fewer. With
    caps far below the emitted lanes and hits every batch is rerun at its
    harvest with raised caps."""
    k, w, seqs, sp_hi, sp_lo, want = many_case
    calls = []
    if retry:
        real = tk.join_rows
        monkeypatch.setattr(tk, "emit_cap", lambda w, sb: 16)
        monkeypatch.setattr(tk, "hit_cap", lambda w, sb, R: 8)
        monkeypatch.setattr(tk, "join_rows",
                            lambda *a: calls.append(a[-2:]) or real(*a))
    got = tk.join_many(seqs, k, w, sp_hi, sp_lo, device="cpu",
                       rows_per_call=rows_per_call, super_blocks=2)
    _assert_hits_equal(got, want)
    if retry:
        assert (16, 8) in calls and any(c != (16, 8) for c in calls)


def _run(gfa, reads, out, **kw):
    return pipeline.run_pipeline(gfa, reads, out, Options(**kw),
                                 device="cpu")


def test_rerun_hits_every_cache(tmp_path):
    """Run 2 re-loads the graph (the held panel dropped): the slot, the
    device cache (by content) and the switch-source slot hit; its arrays
    and FASTA equal run 1's."""
    gfa, reads = _mosaic(tmp_path)
    kw = dict(recombination=5.0)
    before = (dict(dv.PACK_CACHE_STATS), dict(dp.DEV_CACHE_STATS),
              dict(prep.ESRC_CACHE_STATS))
    r1 = _run(gfa, reads, str(tmp_path / "a.fa"), **kw)
    mid = (dict(dv.PACK_CACHE_STATS), dict(dp.DEV_CACHE_STATS),
           dict(prep.ESRC_CACHE_STATS))
    clear_panel()
    r2 = _run(gfa, reads, str(tmp_path / "b.fa"), **kw)
    pack, devc, esrc = (dict(dv.PACK_CACHE_STATS), dict(dp.DEV_CACHE_STATS),
                        dict(prep.ESRC_CACHE_STATS))
    assert mid[0]["stores"] == before[0]["stores"] + 1
    assert pack["hits"] == mid[0]["hits"] + 1
    assert pack["stores"] == mid[0]["stores"]
    assert mid[1]["builds"] - before[1]["builds"] >= 3
    assert devc["builds"] == mid[1]["builds"]
    assert devc["content_hits"] >= mid[1]["content_hits"] + 1
    assert mid[2]["builds"] == before[2]["builds"] + 1
    assert esrc == {"hits": mid[2]["hits"] + 1, "builds": mid[2]["builds"]}
    assert r1.graph is not r2.graph
    with open(tmp_path / "a.fa", "rb") as a, open(tmp_path / "b.fa",
                                                  "rb") as b:
        assert a.read() == b.read()
    o1, o2 = r1.anchors.device_occ, r2.anchors.device_occ
    assert np.array_equal(r1.anchors.per_hap_minimizers,
                          r2.anchors.per_hap_minimizers)
    for a, b in zip(o1.materialize(), o2.materialize()):
        assert np.array_equal(a, b)
    # the memory model's slot row is the slot's bytes
    slot = budget_of_run(r2, 31, 25)["per_device_bytes"]["anchors"][
        "packed-batch cache slot (<= PHI_TPU_PACK_CACHE_MB)"]
    assert slot == o2.pack_bytes == dv.pack_cache_bytes() > 0


def test_solver_statics_upload_once_per_ladder(tmp_path, monkeypatch):
    """The open-gap instance takes several solves on its ladder; the
    switch sources and lane tables are uploaded once in the first run and
    not at all in a second run on the re-loaded graph."""
    gfa, reads = _refinement(tmp_path, seed=19)
    kw = dict(k=4, w=2, recombination=1.0, lagrangian_rounds=6)
    seen = {"esrc": 0, "lanes": 0, "solves": 0}

    def counted(name, real):
        def f(*a, **k):
            seen[name] += 1
            return real(*a, **k)
        return f

    monkeypatch.setattr(state, "esrc_tensors",
                        counted("esrc", state.esrc_tensors))
    monkeypatch.setattr(state, "lane_tensors",
                        counted("lanes", state.lane_tensors))
    monkeypatch.setattr(pipeline, "solve_dp",
                        counted("solves", pipeline.solve_dp))
    r1 = _run(gfa, reads, str(tmp_path / "a.fa"), **kw)
    assert r1.anchors.device_occ is not None
    assert seen["solves"] >= 2
    assert (seen["esrc"], seen["lanes"]) == (1, 1)
    clear_panel()
    _run(gfa, reads, str(tmp_path / "b.fa"), **kw)
    assert seen["solves"] >= 4
    assert (seen["esrc"], seen["lanes"]) == (1, 1)


def _chain_gfa(path, cuts, seq):
    """A linear chain of len(cuts) + 1 nodes cut at `cuts`, walked by
    three haplotypes: equal walk sequences and walk_mat for any cuts."""
    bounds = [0, *cuts, len(seq)]
    segs = [seq[a:b] for a, b in zip(bounds, bounds[1:])]
    lines = ["H\tVN:Z:1.1"]
    lines += [f"S\ts{i}\t{s}" for i, s in enumerate(segs)]
    lines += [f"L\ts{i}\t+\ts{i + 1}\t+\t0M" for i in range(len(segs) - 1)]
    walk = "".join(f">s{i}" for i in range(len(segs)))
    lines += [f"W\tsamp\t{h}\tchr\t0\t{len(seq)}\t{walk}" for h in (1, 2, 3)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_slot_key_holds_the_node_segmentation(tmp_path):
    """Two chops of one sequence: the JAX fingerprint is the same for both
    (the reference's known fault), the port's is not, the second run
    misses the slot, and its result equals a cold run's."""
    from phi_tpu.graph import tensorize
    from phi_tpu.io.gfa import read_gfa
    from phi_tpu_torch.graph.pangenome import tensorize as port_tensorize
    from phi_tpu_torch.io.gfa import read_gfa as port_read_gfa
    rng = np.random.default_rng(5)
    seq = "".join(rng.choice(list("ACGT"), 12000))
    cuts_a = list(range(100, 12000, 100))
    cuts_b = [c + 37 for c in cuts_a]
    paths = [_chain_gfa(tmp_path / f"{n}.gfa", c, seq)
             for n, c in (("a", cuts_a), ("b", cuts_b))]
    jg = [tensorize(read_gfa(p)) for p in paths]
    assert jdev._graph_fingerprint(jg[0]) == jdev._graph_fingerprint(jg[1])
    g = [port_tensorize(port_read_gfa(p)) for p in paths]
    assert np.array_equal(g[0].walk_mat, g[1].walk_mat)
    assert dv.graph_fingerprint(g[0]) != dv.graph_fingerprint(g[1])
    sp = _spectrum([seq[2000:2600], seq[7000:7900]], K, W)

    def join(graph):
        # a threshold above the walk count: the three equal walks keep
        # their k-mers
        seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
        return dv.join_anchors_device(graph, seqs, K, W, sp[0], sp[1], 2.0,
                                      device="cpu", **GEOM)

    join(g[0])
    stats = dict(dv.PACK_CACHE_STATS)
    second = join(g[1])
    assert dv.PACK_CACHE_STATS["hits"] == stats["hits"]
    assert dv.PACK_CACHE_STATS["stores"] == stats["stores"] + 1
    dv.clear_pack_cache()
    cold = join(g[1])
    _assert_same(second, cold[0], cold[1])
    first = join(g[0])[1]
    assert second[1].n_occ > 0 and first.n_occ > 0
    assert not np.array_equal(second[1].materialize()[1],
                              first.materialize()[1])


def test_run_above_the_gate_empties_the_slot(anchors_case, monkeypatch):
    want_min, want_occ = anchors_case[4]
    _port_join(anchors_case)
    assert dv.pack_cache_bytes() > 0
    drops = dv.PACK_CACHE_STATS["drops"]
    monkeypatch.setenv("PHI_TPU_PACK_CACHE_MB", "0")
    got = _port_join(anchors_case)
    assert dv.pack_cache_bytes() == 0 and "slot" not in dv._PACK_CACHE
    assert dv.PACK_CACHE_STATS["drops"] == drops + 1
    assert got[1].pack_bytes == 0
    _assert_same(got, want_min, want_occ)


def test_walk_hashes_kept_only_below_the_gate(anchors_case, monkeypatch):
    """walk_mat and its prefix hashes stay in the device cache when a
    re-run can find them by content; above PHI_TPU_DEV_CACHE_MB the join
    builds them for itself and leaves nothing in the cache."""
    want_min, want_occ = anchors_case[4]
    _port_join(anchors_case)
    assert [k for k in dp._DEV_CACHE if k[-2:] == ("wm_ph", "cpu")]
    dp.clear_dev_cache()
    monkeypatch.setenv("PHI_TPU_DEV_CACHE_MB", "0")
    _assert_same(_port_join(anchors_case), want_min, want_occ)
    assert not dp._DEV_CACHE


def test_dev_cached_evicts_at_12_and_gates_content(monkeypatch):
    built = []

    def build(a):
        return lambda: built.append(a) or (state._t(a, state.torch.int64,
                                                    "cpu"),)
    arrays = [np.full(16, i, np.int32) for i in range(13)]
    monkeypatch.setenv("PHI_TPU_DEV_CACHE_MB", "0")   # id keys only
    for a in arrays:
        dp._dev_cached(a, ("t",), "cpu", build(a))
    assert len(dp._DEV_CACHE) == dp._DEV_CACHE_CAP == 12
    dp._dev_cached(arrays[-1], ("t",), "cpu", build(arrays[-1]))
    assert len(built) == 13       # an id hit
    dp._dev_cached(arrays[0], ("t",), "cpu", build(arrays[0]))
    assert len(built) == 14       # the first key was dropped
    copy = arrays[5].copy()
    dp._dev_cached(copy, ("t",), "cpu", build(copy))
    assert len(built) == 15       # no content key above the gate
    monkeypatch.setenv("PHI_TPU_DEV_CACHE_MB", "256")
    dp.clear_dev_cache()
    first = dp._dev_cached(arrays[1], ("t",), "cpu", build(arrays[1]))
    again = dp._dev_cached(arrays[1].copy(), ("t",), "cpu", build(None))
    assert again is first and len(built) == 16   # a content hit
    for _ in range(dp._DEV_CACHE_CAP):   # each content hit adds an id key
        dp._dev_cached(arrays[1].copy(), ("t",), "cpu", build(None))
    assert len(dp._DEV_CACHE) == dp._DEV_CACHE_CAP and len(built) == 16
    other = dp._dev_cached(arrays[1].copy(), ("t",), "meta",
                           build(arrays[1]))
    assert other is not first and len(built) == 17  # keys hold the device


def test_raising_pack_worker_propagates(anchors_case, monkeypatch):
    real = dv.pack_batch

    def pack(seqs, cumlens, batch, *a):
        if batch[0][0] == 2:
            raise RuntimeError("pack failed")
        return real(seqs, cumlens, batch, *a)
    monkeypatch.setattr(dv, "pack_batch", pack)
    monkeypatch.setenv("PHI_TPU_PACK_WORKERS", "3")
    with pytest.raises(RuntimeError, match="pack failed"):
        _port_join(anchors_case)
    assert "slot" not in dv._PACK_CACHE


def test_raising_join_many_packer_propagates(many_case, monkeypatch):
    k, w, seqs, sp_hi, sp_lo, _ = many_case
    monkeypatch.setattr(tk, "pack_row_left",
                        lambda *a: (_ for _ in ()).throw(ValueError("left")))
    with pytest.raises(ValueError, match="left"):
        tk.join_many(seqs, k, w, sp_hi, sp_lo, device="cpu",
                     rows_per_call=2, super_blocks=2)


def _labels(err: str, prefix: str) -> set:
    """The labels of the profiler's lines: 'x: t' marks and 'key=v'
    fields; per-batch lines as 'batch harvest'."""
    out = set()
    for line in err.splitlines():
        if not line.startswith(prefix):
            continue
        body = line[len(prefix):].strip()
        if re.fullmatch(r"batch \d+ harvest [\d.]+", body):
            out.add("batch harvest")
        elif "=" in body:
            out |= {f.split("=")[0] for f in body.split()}
        else:
            out.add(body.rsplit(":", 1)[0])
    return out


# the stage labels of the JAX package's [danchor-prof] / [join-prof]
# lines, each with the port's span of that stage (under the caller's span);
# the lines' other labels are counts, which no span holds
JAX_STAGES = {"rows+seqscan": "plan", "make_cuckoo": "cuckoo",
              "fingerprint": "fingerprint", "loop_done": "join",
              "pack_wait": "join_pack_wait", "dispatch": "join_dispatch",
              "harvest": "join_harvest", "batch harvest": "join_harvest",
              "ph_build": "walk_hashes", "finalize+stats": "filter"}
JAX_COUNTS = {"batches", "total_hits", "TOT", "n_occ", "max_span", "n_amb",
              "owner_rounds"}


@pytest.mark.parametrize("join", ["join_anchors_device", "join_many"])
def test_join_spans_carry_the_jax_labels(anchors_case, many_case,
                                         monkeypatch, capsys, join):
    """The port's join spans hold every stage the JAX package's profiler
    lines time (at the level that writes all of them), and the port writes
    no such line; join_many adds plan, cuckoo and its batches' parent,
    join."""
    from phi_tpu_torch.trace import recording, span
    capsys.readouterr()
    if join == "join_anchors_device":
        jgraph, graph, seqs, sp, _ = anchors_case
        monkeypatch.setenv("PHI_TPU_JOIN_PROF", "2")
        jdev.join_anchors_device(jgraph, seqs, K, W, sp[0], sp[1], 1.0,
                                 interpret=True, **GEOM)
        labels = _labels(capsys.readouterr().err, "[danchor-prof]")

        def port():
            return _port_join(anchors_case)
    else:
        k, w, mseqs, sp_hi, sp_lo, _ = many_case
        monkeypatch.setenv("PHI_TPU_JOIN_PROF", "1")
        jk.pallas_join_many(mseqs, k, w, jnp.asarray(sp_hi),
                            jnp.asarray(sp_lo), rows_per_call=5,
                            super_blocks=2, interpret=True)
        labels = _labels(capsys.readouterr().err, "[join-prof]")

        def port():
            return tk.join_many(mseqs, k, w, sp_hi, sp_lo, device="cpu",
                                rows_per_call=5, super_blocks=2)
    assert labels and labels <= set(JAX_STAGES) | JAX_COUNTS
    want = {JAX_STAGES[label] for label in labels if label in JAX_STAGES}
    with recording() as t:
        with span("sketch_haps"):
            port()
    got = {key[len("sketch_haps_"):] for key in t if key != "sketch_haps"}
    extra = set() if join == "join_anchors_device" else \
        {"plan", "cuckoo", "join"}
    assert got == want | extra
    assert sum(t[f"sketch_haps_join_{s}"] for s in
               ("pack_wait", "dispatch", "harvest")) \
        <= t["sketch_haps_join"] <= t["sketch_haps"]
    assert "-prof]" not in capsys.readouterr().err
