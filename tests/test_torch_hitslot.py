"""The hit path's packed batches held on the device, on the CPU: join_many,
given the panel's content fingerprint (pipeline._join_hits passes it),
keeps its row plan and uploaded batches in the packed-batch slot, and a
later join on the same panel, k, w and geometry is served from there.
The panel is test_torch_widepanel's: 300 walks of the benchmark's recipe
at ROWS 8, SUPER_BLOCKS 2.

- A second inference on the held panel counts a hit of
  `cache_counts()["hits_slot"]`, and its per-walk (n_min, positions, ids)
  and FASTA equal a cold run's after clear_caches(); both answers read 0
  on every number of `phibench.check.judge`; the memory model counts the
  held batches as the slot's row.
- A changed k, w, geometry or panel stores, and joins as a join without
  the slot does; a walk holding N comes back None on a hit as on a
  store, whatever the caller did with the last result; a plan over
  PHI_TPU_PACK_CACHE_MB misses and holds nothing; a mesh, or a graph with
  no fingerprint, misses and leaves the slot as it was.
- A device-route run after a hit-path run replaces the slot, and the
  reverse; clear_caches() empties it.
- The benchmark's `hits_slot_hit_share` reader reads 100, 0, and None
  where the program has no such counter.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from phibench import check, harness, program, synth
from phibench import reference as ref
from phi_tpu_torch import pipeline
from phi_tpu_torch.anchors import device as tdev
from phi_tpu_torch.config import Options
from phi_tpu_torch.eval import onchip
from phi_tpu_torch.eval.hbm_budget import budget_of_run
from phi_tpu_torch.io.reads import load_read_batch
from phi_tpu_torch.sketch import kernels as tk

K, W, R, T = 15, 5, 5.0, 1.0
WIDE, NARROW, LENGTH = 300, 6, 4000
ROWS, SB = 8, 2
SEEDS = (2**31 + 23, 2**34 + 5)
SLOT_ROW = "packed-batch cache slot (<= PHI_TPU_PACK_CACHE_MB)"


def _traffic() -> dict:
    with open(os.path.join(os.path.dirname(harness.HERE), "phibench",
                           "traffic", "batch-1x.json")) as f:
        return json.load(f)


def _counts() -> dict:
    return dict(tdev.HITS_SLOT_STATS)


def _delta(before: dict) -> dict:
    return {c: n - before[c] for c, n in tdev.HITS_SLOT_STATS.items()}


def _slot_route():
    """The route field of the slot's key (None when the slot is empty)."""
    slot = tdev._PACK_CACHE.get("slot")
    return None if slot is None else slot[0][-3 if len(slot) == 2 else -2]


class Case:
    """A panel written as a GFA, and seeded samples' reads."""

    def __init__(self, tmp, n_haps: int, seeds):
        self.tmp = tmp
        self.panel = synth.make_panel(n_haps, LENGTH, n_haps, 0.01, 0.05, 30)
        self.gfa = os.path.join(tmp, f"p{n_haps}.gfa")
        synth.write_gfa(self.panel, self.gfa)
        self.samples, self.fq = {}, {}
        for seed in seeds:
            self.samples[seed] = synth.make_sample(self.panel, seed, 1, 0,
                                                   _traffic())
            self.fq[seed] = os.path.join(tmp, f"{n_haps}_{seed}.fq.gz")
            synth.write_fastq(self.samples[seed].reads, self.fq[seed])

    def run(self, name: str, seed: int = SEEDS[0], **kw):
        fa = os.path.join(self.tmp, f"{name}.fa")
        with pytest.MonkeyPatch.context() as mp:
            for mod in (tk, tdev):
                mp.setattr(mod, "ROWS", ROWS)
                mp.setattr(mod, "SUPER_BLOCKS", SB)
            res = pipeline.run_pipeline(
                self.gfa, self.fq[seed], fa,
                Options(k=K, w=W, recombination=R, threshold=T, **kw),
                device="cpu")
        return res, fa

    def spectrum(self, k: int = K, w: int = W):
        return pipeline.read_spectrum(load_read_batch(self.fq[SEEDS[0]]),
                                      k, w)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Two samples on the held 300-walk panel (the second served from the
    slot), then the second sample cold after clear_caches()."""
    onchip.clear_caches()
    try:
        case = Case(str(tmp_path_factory.mktemp("hitslot")), WIDE, SEEDS)
        out = {"case": case, "deltas": []}
        for name, seed in zip("ab", SEEDS):
            before = onchip.cache_counts()
            out[name] = case.run(name, seed)
            out["deltas"].append(onchip.cache_delta(before,
                                                    onchip.cache_counts()))
        out["held_bytes"] = tdev.pack_cache_bytes()
        out["budget_slot"] = budget_of_run(out["b"][0], K, W)[
            "per_device_bytes"]["anchors"][SLOT_ROW]
        onchip.clear_caches()
        out["cold"] = case.run("cold", SEEDS[1])
        yield out
    finally:
        onchip.clear_caches()


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """A 6-walk panel: the device route's width, and cheap joins."""
    case = Case(str(tmp_path_factory.mktemp("narrow")), NARROW, SEEDS[:1])
    res, _ = case.run("narrow")
    return case, res.graph


@pytest.fixture(autouse=True)
def cold_slot():
    tdev.clear_pack_cache()
    yield
    tdev.clear_pack_cache()


def test_second_inference_is_served_from_the_slot(served):
    assert served["deltas"][0]["hits_slot"] == {"hits": 0, "stores": 1,
                                                "misses": 0}
    assert served["deltas"][1]["hits_slot"] == {"hits": 1, "stores": 0,
                                                "misses": 0}
    (res, fa), (cold, cold_fa) = served["b"], served["cold"]
    assert res.graph is served["a"][0].graph   # the held panel
    assert res.hits is not None and len(res.hits) == WIDE
    for (n, pos, ids), (n0, pos0, ids0) in zip(res.hits, cold.hits):
        assert n == n0
        np.testing.assert_array_equal(pos, pos0)
        np.testing.assert_array_equal(ids, ids0)
    with open(fa, "rb") as a, open(cold_fa, "rb") as b:
        assert a.read() == b.read()
    t = res.timings
    for key in ("sketch_haps_hits_fingerprint", "sketch_haps_hits_plan",
                "sketch_haps_hits_join_pack_wait"):
        assert key in t and t[key] >= 0.0, key
    # the memory model's slot row is the held batches' bytes
    assert served["budget_slot"] == served["held_bytes"] > 0


@pytest.mark.parametrize("name", ["a", "b"], ids=["stored", "served"])
def test_answers_match_the_reference(served, name):
    case = served["case"]
    seed = SEEDS["ab".index(name)]
    res, fa = served[name]
    if "pi" not in served:
        served["pi"] = ref.index_panel(case.panel, K, W, "cpu")
    pi = served["pi"]
    out = program.outputs(res, fa, R, 0.99)
    an = ref.anchors(pi, ref.read_spectrum(case.samples[seed].reads, K, W,
                                           "cpu"), T)
    bound = ref.relaxed_bound(pi, an, R, torch.float64,
                              ref.switch_sources(pi))
    vals = check.judge(out, an, bound, pi, case.panel)
    assert set(vals) == set(check.limits({"certify_tol": 0.99}))
    assert all(v == 0 for v in vals.values()), vals
    assert out["certified"]


def _join(case, graph, k=K, w=W, rows=ROWS, sb=SB, panel=True):
    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    fp = tdev.graph_fingerprint(graph) if panel is True else panel
    return tk.join_many(seqs, k, w, *case.spectrum(k, w), device="cpu",
                        rows_per_call=rows, super_blocks=sb, panel=fp)


def _same_hits(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])


@pytest.mark.parametrize("change", [dict(k=17), dict(w=7), dict(rows=4),
                                    dict(sb=1), dict(panel="other")],
                         ids=["k", "w", "rows", "super_blocks", "panel"])
def test_a_changed_key_stores(narrow, served, change):
    case, graph = narrow
    _join(case, graph)
    again = _counts()
    _join(case, graph)
    assert _delta(again) == {"hits": 1, "stores": 0, "misses": 0}
    if change.get("panel") == "other":
        change = dict(panel=tdev.graph_fingerprint(served["a"][0].graph))
        assert change["panel"] != tdev.graph_fingerprint(graph)
    before = _counts()
    got = _join(case, graph, **change)
    assert _delta(before) == {"hits": 0, "stores": 1, "misses": 0}
    _same_hits(got, _join(case, graph, **dict(change, panel=None)))
    assert _delta(before) == {"hits": 0, "stores": 1, "misses": 0}


def test_served_plan_is_the_callers_own(narrow):
    """A walk holding N gets no rows and comes back None for the caller's
    host join, on a hit too: filling the returned list leaves the held
    plan as it was."""
    case, graph = narrow
    seqs = [graph.walk_seq_codes(h).copy() for h in range(graph.num_walks)]
    seqs[1][100] = 4
    fp = tdev.graph_fingerprint(graph)
    spectrum = case.spectrum()
    first = tk.join_many(seqs, K, W, *spectrum, device="cpu",
                         rows_per_call=ROWS, super_blocks=SB, panel=fp)
    assert first[1] is None and first[0] is not None
    first[1] = first[0]
    before = _counts()
    again = tk.join_many(seqs, K, W, *spectrum, device="cpu",
                         rows_per_call=ROWS, super_blocks=SB, panel=fp)
    assert _delta(before) == {"hits": 1, "stores": 0, "misses": 0}
    assert again[1] is None
    _same_hits([h for h in again if h is not None],
               [h for i, h in enumerate(first) if i != 1])


def test_plan_over_the_cap_misses_and_holds_nothing(narrow, monkeypatch):
    case, graph = narrow
    want = _join(case, graph)
    assert tdev.pack_cache_bytes() > 0
    monkeypatch.setenv("PHI_TPU_PACK_CACHE_MB", "0")
    before = _counts()
    got = _join(case, graph)
    assert _delta(before) == {"hits": 0, "stores": 0, "misses": 1}
    assert "slot" not in tdev._PACK_CACHE and tdev.pack_cache_bytes() == 0
    _same_hits(got, want)


@pytest.mark.parametrize("why", ["mesh", "no_fingerprint"])
def test_unkeyed_join_misses_and_leaves_the_slot(narrow, monkeypatch, why):
    case, graph = narrow
    want = _join(case, graph)
    held = tdev._PACK_CACHE["slot"]
    devices = None
    if why == "mesh":
        devices = [torch.device("cpu")] * 2
    else:
        monkeypatch.setattr(pipeline, "graph_fingerprint", lambda g: None)
    monkeypatch.setattr(tk, "ROWS", ROWS)
    monkeypatch.setattr(tk, "SUPER_BLOCKS", SB)
    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    before = _counts()
    got = pipeline._join_hits(graph, seqs, Options(k=K, w=W),
                              case.spectrum(), torch.device("cpu"), devices)
    assert _delta(before) == {"hits": 0, "stores": 0, "misses": 1}
    assert tdev._PACK_CACHE["slot"] is held
    _same_hits(got, want)


def test_routes_replace_each_other(narrow, tmp_path):
    """On one panel: the device route stores its batches, the hit path
    (--save-index) stores over them, and the device route again."""
    case, _ = narrow
    idx = str(tmp_path / "idx.npz")
    for save, route in ((None, "v3"), (idx, "hits"), (None, "v3"),
                        (idx, "hits")):
        pack, hits = dict(tdev.PACK_CACHE_STATS), _counts()
        case.run(f"route_{route}", save_index=save)
        assert _slot_route() == route
        if route == "hits":
            assert _delta(hits) == {"hits": 0, "stores": 1, "misses": 0}
            assert tdev.PACK_CACHE_STATS["stores"] == pack["stores"]
        else:
            assert _delta(hits) == {"hits": 0, "stores": 0, "misses": 0}
            assert tdev.PACK_CACHE_STATS["stores"] == pack["stores"] + 1
            assert tdev.PACK_CACHE_STATS["hits"] == pack["hits"]


def test_clear_caches_empties_the_slot(narrow):
    case, graph = narrow
    _join(case, graph)
    assert tdev.pack_cache_bytes() > 0
    assert onchip.cache_counts()["pack_slot_bytes"] > 0
    onchip.clear_caches()
    assert "slot" not in tdev._PACK_CACHE
    assert onchip.cache_counts()["pack_slot_bytes"] == 0
    before = _counts()
    _join(case, graph)
    assert _delta(before) == {"hits": 0, "stores": 1, "misses": 0}


def test_hits_slot_hit_share_reader(served):
    mod = harness.load_module(
        os.path.join(harness.HERE, "metrics", "hits_slot_hit_share.py"),
        "hits_slot_hit_share")

    def read(delta):
        return mod.read(types.SimpleNamespace(cache_delta=delta))
    first, second = served["deltas"]
    assert read(second) == 100.0
    assert read(first) == 0.0
    without = {k: v for k, v in second.items() if k != "hits_slot"}
    assert read(without) is None
    assert read(None) is None
    assert read(dict(without, hits_slot={"hits": 0, "stores": 0,
                                         "misses": 0})) is None
    assert np.isclose(read(dict(without, hits_slot={
        "hits": 3, "stores": 1, "misses": 0})), 75.0)
