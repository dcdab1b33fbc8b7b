"""A panel wider than the device anchors' u8 hap column, on the CPU: 300
walks of the benchmark's panel recipe (`phibench.synth`) take the hit
path (join_many, then the native anchor tables), and the answers are
held to the benchmark's plain reference (`phibench/reference.py`) through
the comparison that decides a run's `correct` (`phibench.check.judge`,
as `phibench.harness.verify` calls it).

- Every compared number reads 0 on two seeded samples, and each answer
  is certified.
- The route counter (`cache_counts()["anchor_route"]`) counts `hits` once
  per inference; the hit path's spans key as `sketch_haps_hits_*` and
  `anchors_native`, and the children of `sketch_haps` cover it.
- A 6-walk panel takes `v3`, keeps the device route's span keys and has
  no `sketch_haps_hits_*` key.
- The benchmark's `hit_path_share` reader reads 100, 0, and None where
  the program has no route counter.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from phibench import check, harness, program, synth
from phibench import reference as ref
from phi_tpu_torch.anchors import device as tdev
from phi_tpu_torch.config import Options
from phi_tpu_torch.eval import onchip
from phi_tpu_torch.pipeline import run_pipeline
from phi_tpu_torch.sketch import kernels as tk

K, W, R, T = 15, 5, 5.0, 1.0
WIDE, NARROW, LENGTH = 300, 6, 4000
SEEDS = (2**31 + 11, 2**33 + 7)


def _traffic() -> dict:
    with open(os.path.join(os.path.dirname(harness.HERE), "phibench",
                           "traffic", "batch-1x.json")) as f:
        return json.load(f)


def _runs(tmp, n_haps: int, seeds) -> dict:
    """The panel, the route counter's delta, and per seed (sample, result,
    FASTA) of run_pipeline at a small join geometry (the results do not
    depend on it)."""
    panel = synth.make_panel(n_haps, LENGTH, n_haps, 0.01, 0.05, 30)
    gfa = os.path.join(tmp, f"p{n_haps}.gfa")
    synth.write_gfa(panel, gfa)
    out = {"panel": panel, "runs": []}
    before = onchip.cache_counts()
    with pytest.MonkeyPatch.context() as mp:
        for mod in (tk, tdev):
            mp.setattr(mod, "ROWS", 8)
            mp.setattr(mod, "SUPER_BLOCKS", 2)
        for seed in seeds:
            s = synth.make_sample(panel, seed, 1, 0, _traffic())
            fq = os.path.join(tmp, f"{n_haps}_{seed}.fq.gz")
            fa = os.path.join(tmp, f"{n_haps}_{seed}.fa")
            synth.write_fastq(s.reads, fq)
            res = run_pipeline(gfa, fq, fa, Options(k=K, w=W, recombination=R,
                                                    threshold=T),
                               device="cpu")
            out["runs"].append((s, res, fa))
    out["delta"] = onchip.cache_delta(before, onchip.cache_counts())
    return out


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    onchip.clear_caches()
    try:
        yield _runs(str(tmp_path_factory.mktemp("wide")), WIDE, SEEDS)
    finally:
        onchip.clear_caches()


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    onchip.clear_caches()
    try:
        yield _runs(str(tmp_path_factory.mktemp("narrow")), NARROW,
                    SEEDS[:1])
    finally:
        onchip.clear_caches()


def test_wide_panel_matches_the_reference(wide):
    panel = wide["panel"]
    pi = ref.index_panel(panel, K, W, "cpu")
    sources = ref.switch_sources(pi)
    for s, res, fa in wide["runs"]:
        out = program.outputs(res, fa, R, 0.99)
        an = ref.anchors(pi, ref.read_spectrum(s.reads, K, W, "cpu"), T)
        bound = ref.relaxed_bound(pi, an, R, torch.float64, sources)
        vals = check.judge(out, an, bound, pi, panel)
        assert set(vals) == set(check.limits({"certify_tol": 0.99}))
        assert all(v == 0 for v in vals.values()), vals
        assert out["certified"]
        assert len(out["minimizers"]) == WIDE and sum(out["anchors"]) > 0
        assert res.hits is not None and res.anchors.device_occ is None


def test_wide_panel_takes_the_hit_path_with_its_spans(wide):
    n = len(wide["runs"])
    assert wide["delta"]["anchor_route"] == {
        "v3": 0, "v3w": 0, "v2ck": 0, "v2mixed": 0, "hits": n}
    for _, res, _ in wide["runs"]:
        t = res.timings
        for key in ("sketch_haps_hits", "sketch_haps_hits_plan",
                    "sketch_haps_hits_cuckoo", "sketch_haps_hits_join",
                    "sketch_haps_hits_join_pack_wait",
                    "sketch_haps_hits_join_dispatch",
                    "sketch_haps_hits_join_harvest", "anchors_native"):
            assert key in t and t[key] >= 0.0, key
        for key in ("sketch_haps_plan", "sketch_haps_cuckoo",
                    "sketch_haps_join", "sketch_haps_filter"):
            assert key not in t, key
        assert t["anchors_native"] <= t["anchors"]
        kids = t["sketch_haps_walk_codes"] + t["sketch_haps_hits"]
        assert 0.99 * t["sketch_haps"] <= kids <= t["sketch_haps"]


def test_narrow_panel_keeps_the_device_route(narrow):
    assert narrow["delta"]["anchor_route"] == {
        "v3": 1, "v3w": 0, "v2ck": 0, "v2mixed": 0, "hits": 0}
    _, res, _ = narrow["runs"][0]
    t = res.timings
    assert res.anchors.device_occ.route == "v3"
    for key in ("sketch_haps_plan", "sketch_haps_cuckoo", "sketch_haps_join"):
        assert key in t, key
    assert not [k for k in t if k.startswith("sketch_haps_hits")]
    assert "anchors_native" not in t


def test_hit_path_share_reader(wide, narrow):
    mod = harness.load_module(
        os.path.join(harness.HERE, "metrics", "hit_path_share.py"),
        "hit_path_share")

    def read(delta):
        return mod.read(types.SimpleNamespace(cache_delta=delta))
    assert read(wide["delta"]) == 100.0
    assert read(narrow["delta"]) == 0.0
    without = {k: v for k, v in wide["delta"].items() if k != "anchor_route"}
    assert read(without) is None
    assert read(None) is None
    assert np.isclose(read(dict(without, anchor_route={
        "v3": 3, "v3w": 0, "v2ck": 0, "v2mixed": 0, "hits": 1})), 25.0)
