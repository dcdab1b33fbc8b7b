"""The port's chromosome-scale record runner (eval.onchip) against
phi_tpu's on the CPU, on tests/test_subset.py's 4 x 20 kbp instance with
CACHE_DIR pointed into the test's directory in both packages: the same
keys in the same order, and every field equal but the walls, the timings
and the RSS, and the fields that name what ran it (backend, device, device
count, the device-memory figure and its source), which the port sets from
its own device: on the CPU "cpu", one device and the memory model's total
(source "analytic"), where phi_tpu's CPU backend reports no memory. The
port's record adds `caches`, each run's cache record: the caches are
dropped before the warm run, so it packs, stores and uploads again."""

import json

import pytest

pytest.importorskip("jax")

import phi_tpu.eval.onchip as jonchip  # noqa: E402
import phi_tpu.eval.scale as jscale  # noqa: E402
from phi_tpu_torch.eval import onchip, scale  # noqa: E402

TIME_KEYS = {"cold_wall_s", "warm", "warm_calm", "peak_rss_gb",
             "timings_last_run"}
DEVICE_KEYS = {"backend", "device", "n_devices", "hbm_peak_gb",
               "hbm_peak_gb_source"}


@pytest.fixture
def caches(tmp_path, monkeypatch):
    monkeypatch.setattr(scale, "CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jscale, "CACHE_DIR", str(tmp_path / "jax"))
    return tmp_path


def test_record_matches_jax(caches):
    args = (4, 20_000, 2.0, 3, 2, 1)
    got = onchip.run(*args, device="cpu")
    want = jonchip.run(*args)
    assert [k for k in got if k != "caches"] == list(want)
    assert len(got["caches"]) == 2
    for run in got["caches"]:
        assert run["pack_slot"]["hits"] == 0
        assert run["pack_slot"]["stores"] == 1
        assert run["pack_slot_bytes"] > 0
        assert run["panel"]["loads"] == 1
    for key in set(want) - TIME_KEYS - DEVICE_KEYS:
        assert got[key] == want[key], key
    for key in ("warm", "warm_calm"):
        assert list(got[key]) == list(want[key])
        assert got[key]["n_runs"] == want[key]["n_runs"] == 1
    assert got["warm_calm"]["stalled_runs"] == 0
    assert set(got["timings_last_run"]) >= {"load_graph", "solve", "total"}
    assert (got["backend"], got["device"], got["n_devices"]) == \
        ("cpu", "cpu", 1)
    assert got["hbm_peak_gb_source"] == "analytic" and got["hbm_peak_gb"] > 0
    assert got["gap"] <= 0.99 and got["true_breaks"] == 2


def test_cli_writes_the_record_and_refuses_cuda_without_a_card(caches,
                                                                capsys):
    import torch
    out = caches / "rec.json"
    argv = ["--haps", "3", "--length", "20000", "--runs", "1", "--seed",
            "3", "--lagrangian", "1"]
    assert onchip.main(argv + ["--device", "cpu", "--out", str(out)]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert json.loads(out.read_text()) == printed
    assert printed["n_haps"] == 3 and printed["warm"] is None
    if not torch.cuda.is_available():
        assert onchip.main(argv) == 1
        assert "[E::main]" in capsys.readouterr().err
