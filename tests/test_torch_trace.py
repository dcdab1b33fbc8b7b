"""`phi_tpu_torch.trace`: the device-time summary (overlapping device
events count once in the busy time, and a CPU-only profile has none); the
span recorder (keys nest as `<parent>_<name>` and accumulate, nothing is
recorded outside a run or from another thread, `phi.*` profiler ranges
only while a profiler records, lasting what `timings` says); a toy
run_pipeline's keys; and the busy and idle seconds by span."""

import threading
import time

import pytest
import torch

from phi_tpu_torch import trace
from phi_tpu_torch.trace import (busy_by_span, device_events, idle_by_span,
                                 merged_us, recording, span, span_ranges,
                                 summarize)


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0.0, 2.0)], 2.0),
    ([(1.0, 3.0), (0.0, 2.0), (5.0, 6.0)], 4.0),   # overlap and a gap
    ([(0.0, 10.0), (2.0, 3.0), (4.0, 5.0)], 10.0),  # nested
    ([(0.0, 1.0), (1.0, 2.0)], 2.0),                # touching
])
def test_merged_us(intervals, want):
    assert merged_us(intervals) == want


def test_summarize_counts_overlap_once():
    events = [("k1", 0.0, 1000.0), ("memcpy", 500.0, 1500.0),
              ("k1", 3000.0, 3500.0)]
    res = summarize(events, wall_s=0.01, profiled_wall_s=0.02)
    assert res["busy_s"] == pytest.approx(0.002)
    assert res["busy_share"] == pytest.approx(0.2)
    assert res["busy_share_profiled"] == pytest.approx(0.1)
    assert res["by_name"][0] == {"name": "k1", "ms": 1.5, "count": 2}
    assert res["by_name"][1] == {"name": "memcpy", "ms": 1.0, "count": 1}


def test_cpu_profile_has_no_device_events():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.arange(1000).sum()
    assert device_events(prof) == []


@pytest.fixture
def clock(monkeypatch):
    """The recorder's clock stepping by one second a read."""
    ticks = iter(range(1000))
    monkeypatch.setattr(trace, "perf_counter", lambda: float(next(ticks)))


def test_span_keys_nest_and_accumulate(clock):
    with recording() as t:
        with span("a"):              # reads 0 .. 9
            with span("b"):          # 1 .. 2
                pass
            with span("b"):          # 3 .. 6
                with span("c"):      # 4 .. 5
                    pass
            with span("d"):          # 7 .. 8
                pass
        with span("b"):              # 10 .. 11: a top-level b of its own
            pass
    assert t == {"a_b": 1.0 + 3.0, "a_b_c": 1.0, "a_d": 1.0, "a": 9.0,
                 "b": 1.0}


def test_no_recording_outside_a_run_or_from_another_thread():
    with span("before"):
        pass
    got = []

    def worker():
        with span("worker"):
            pass
        got.append(True)

    with recording() as t:
        with span("main"):
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=60)
        with recording() as inner:
            with span("inner"):
                pass
        with span("after_inner"):
            pass
    with span("after"):
        pass
    assert not th.is_alive() and got == [True]
    assert set(t) == {"main", "after_inner"}
    assert set(inner) == {"inner"}


def test_profiler_ranges_only_while_a_profiler_records():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as outside:
        with span("nothing"):
            torch.arange(1000).sum()
    assert span_ranges(outside) == []
    with recording() as t:
        with span("unprofiled"):
            torch.arange(1000).sum()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with span("x"):
                time.sleep(0.02)
                with span("y"):
                    torch.arange(1000).sum()
                    time.sleep(0.03)
    ranges = span_ranges(prof)
    assert sorted(k for k, _, _ in ranges) == ["x", "x_y"]
    assert set(t) == {"unprofiled", "x", "x_y"}
    for key, s, e in ranges:
        assert (e - s) / 1e6 == pytest.approx(t[key], abs=5e-3)
    assert not torch._C._autograd._profiler_enabled()


# the keys run_pipeline had before its spans went below the phase level
PHASE_KEYS = {"load_graph", "load_reads", "sketch_reads", "sketch_haps",
              "anchors", "solve", "emit", "total", "solve_tables",
              "solve_exec", "solve_fetch", "solve_decode"}
# the direct children of each span that has them
CHILDREN = {
    "load_graph": ("parse", "tensorize"),
    "sketch_haps": ("walk_codes", "plan", "cuckoo", "join", "walk_hashes",
                    "filter"),
    "sketch_haps_join": ("pack_wait", "dispatch", "harvest"),
    "solve": ("prep", "tables", "exec", "fetch", "hydrate", "decode"),
    "emit": ("path_seq", "write")}
TOP = ("load_graph", "load_reads", "sketch_reads", "sketch_haps", "anchors",
       "solve", "report", "emit")


def test_toy_pipeline_timings_hold_every_span(tmp_path, monkeypatch):
    from phi_tpu_torch.config import Options
    from phi_tpu_torch.eval import onchip, scale
    from phi_tpu_torch.pipeline import run_pipeline
    monkeypatch.setattr(scale, "CACHE_DIR", str(tmp_path))
    paths = scale.build_instance(4, 20_000)
    onchip.clear_caches()   # a cold join packs every batch
    try:
        t = run_pipeline(paths["gfa"], paths["reads"],
                         str(tmp_path / "out.fa"), Options(),
                         device="cpu").timings
    finally:
        onchip.clear_caches()
    spans = {f"{p}_{c}" for p, kids in CHILDREN.items() for c in kids}
    assert PHASE_KEYS | spans | {"report"} <= set(t)
    assert all(v >= 0 for v in t.values())
    assert sum(t[k] for k in TOP) <= t["total"]
    for parent, kids in CHILDREN.items():
        assert sum(t[f"{parent}_{c}"] for c in kids) <= t[parent], parent


def test_busy_and_idle_by_span():
    # spans: a [0, 100] holding a_b [10, 50] and a_b [55, 58]; c [120, 200]
    ranges = [("a", 0.0, 100.0), ("a_b", 10.0, 50.0), ("a_b", 55.0, 58.0),
              ("c", 120.0, 200.0)]
    events = [("k", 20.0, 30.0), ("k", 60.0, 130.0), ("copy", 62.0, 64.0)]
    assert busy_by_span(events, ranges) == {"a": 10.0 + 40.0, "a_b": 10.0,
                                            "c": 10.0}
    # idle: [-10, 20] (other 10, a 10, a_b 10), [30, 60] (a_b 20 + 3,
    # a 7), [130, 220] (c 70, other 20)
    assert idle_by_span(events, ranges, -10.0, 220.0) == {
        "other": 30.0, "a": 17.0, "a_b": 33.0, "c": 70.0}
    assert idle_by_span([], [], 0.0, 5.0) == {"other": 5.0}
