"""The device-time summary of `phi_tpu_torch.trace`: overlapping device
events count once in the busy time, and a CPU-only profile has none."""

import pytest
import torch

from phi_tpu_torch.trace import device_events, merged_us, summarize


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
