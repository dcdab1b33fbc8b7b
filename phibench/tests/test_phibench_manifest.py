"""BENCHMARK.json against the contract's form, and the files it names."""

import json
import os
import re

import pytest

from phibench.tests.phibench_tiny import BENCH, ROOT, merge_left_out

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module", params=["committed", "with_left_out"])
def man(request):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    if request.param == "with_left_out":
        merge_left_out(m)
    return m


def test_keys_and_limits(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= man["run_seconds"] <= 51
    assert man["paths"] == ["phibench"]
    assert 1 <= len(man["configs"]) <= 24 and 1 <= len(man["workloads"]) <= 24
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


def test_names_and_units(man):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    assert all(NAME.match(n) for n in names), names
    assert len(names) == len(set(names))
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in man["end_to_end"]} >= {"setup_s"}


def test_every_cell_reports_what_its_metrics_move(man):
    cells = [w["name"] for w in man["workloads"]]
    e2e = {c: {m["name"] for m in man["end_to_end"]
               if c in m.get("workloads", cells)} for c in cells}
    for c in cells:
        assert "setup_s" in e2e[c] and len(e2e[c]) >= 2
        layer = [m for m in man["per_layer"]
                 if c in m.get("workloads", cells)]
        assert layer, c
        for m in layer:
            assert m["moves"] in e2e[c], (c, m["name"])


def test_named_files_exist(man):
    for c in man["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("phibench/")
    for w in man["workloads"]:
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            t = json.load(f)
        assert os.path.exists(os.path.join(BENCH, "drivers",
                                           t["driver"] + ".py"))
    for m in man["end_to_end"] + man["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py")), m["name"]
