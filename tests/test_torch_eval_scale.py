"""The port's scale and throughput runners against phi_tpu's on the CPU, with
CACHE_DIR pointed into the test's directory in both packages:

- `run_one` and `progressive_subsets` on tests/test_subset.py's 4 x 20 kbp
  instance (counts 2 and 4): every field of every record but the walls,
  the timings and the RSS; the subset panel's bytes; the CSV with those
  columns masked;
- `build_heldout_instance`: the same files from the same seed into the
  same directory names (the reads decompressed: a gzip header holds its
  write time);
- `heldout_sweep` with the best-hap baseline on tests/test_eval.py's
  4 x 60 kbp held-out panel (coverages 0.2 and 2): every cell;
- `bench_sketch`'s spectrum and `bench_join`'s hits at 200 kbp, and the
  v1 join's plan of one 64 Mbp sequence;
- the scale and throughput CLIs: the same JSON keys (and values but the
  times), `--mesh` on the CPU (the `sketch@2dev` record of phi_tpu's
  runner) and refused on cuda without the cards, and exit 1 with
  [E::main] on cuda without a card.
"""

import dataclasses
import gzip
import json
import os
import re

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import phi_tpu.eval.scale as jscale  # noqa: E402
import phi_tpu.eval.throughput as jthroughput  # noqa: E402
from phi_tpu.config import Options as JaxOptions  # noqa: E402
from phi_tpu_torch.config import Options  # noqa: E402
from phi_tpu_torch.eval import scale, throughput  # noqa: E402

# the wall, timing and RSS fields of the records: not compared
TIME_KEYS = {"wall_s", "wall_iqr_s", "wall_raw_s", "peak_rss_gb", "timings",
             "median_s", "iqr_s", "min_s", "max_s", "raw_s", "bases_per_s",
             "kmers_per_s", "real_time_s", "time_iqr_s", "raw_times_s"}


def _untimed(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in TIME_KEYS}


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """CACHE_DIR of each package in a directory of its own."""
    monkeypatch.setattr(scale, "CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jscale, "CACHE_DIR", str(tmp_path / "jax"))
    return tmp_path / "port", tmp_path / "jax"


def _same_files(a: str, b: str) -> None:
    op = gzip.open if a.endswith(".gz") else open
    with op(a, "rb") as fa, op(b, "rb") as fb:
        assert fa.read() == fb.read(), a


def _masked_rows(path: str, cols) -> list[list[str]]:
    with open(path) as f:
        rows = [ln.rstrip("\n").split(",") for ln in f]
    for r in rows[1:]:
        for c in cols:
            r[c] = "T"
    return rows


def test_run_one_and_progressive_subsets_match_jax(caches):
    kw = dict(length=20_000, coverage=2.0, seed=3, n_breaks=1)
    got = scale.run_one(4, **kw, opt=Options(k=15, w=5, lagrangian_rounds=1),
                        target_runs=2, device="cpu")
    want = jscale.run_one(4, **kw,
                          opt=JaxOptions(k=15, w=5, lagrangian_rounds=1),
                          target_runs=2)
    assert list(got) == list(want)
    assert _untimed(got) == _untimed(want)
    assert got["n_runs"] == 2 and set(got["timings"]) >= {"total", "solve"}

    rows = {}
    for mod, opt, d in ((scale, Options, caches[0]),
                        (jscale, JaxOptions, caches[1])):
        paths = mod.build_instance(4, **kw)
        rows[mod] = mod.progressive_subsets(
            paths["gfa"], paths["reads"], paths["truth"], [2, 4],
            opt=opt(k=15, w=5, lagrangian_rounds=1),
            out_csv=str(d / "inc.csv"), target_runs=1,
            **({"device": "cpu"} if mod is scale else {}))
    got, want = rows[scale], rows[jscale]
    assert [r["n_haps"] for r in got] == [2, 4]
    for a, b in zip(got, want):
        assert list(a) == list(b)
        assert _untimed(a) == _untimed(b)
    port_dir = os.path.dirname(scale.build_instance(4, **kw)["gfa"])
    jax_dir = os.path.dirname(jscale.build_instance(4, **kw)["gfa"])
    for name in ("panel_2.gfa", "inferred_2.fa", "inferred_4.fa"):
        _same_files(os.path.join(port_dir, name), os.path.join(jax_dir, name))
    masked = (2, 3, 4, 5, 6, 10)
    assert _masked_rows(str(caches[0] / "inc.csv"), masked) == \
        _masked_rows(str(caches[1] / "inc.csv"), masked)


def test_build_heldout_instance_matches_jax(caches):
    got = scale.build_heldout_instance(3, 30_000, [0.5, 2.0], seed=2)
    want = jscale.build_heldout_instance(3, 30_000, [0.5, 2.0], seed=2)
    assert sorted(got["reads"]) == sorted(want["reads"])
    pairs = [(got["gfa"], want["gfa"]), (got["truth"], want["truth"])] + [
        (got["reads"][c], want["reads"][c]) for c in want["reads"]]
    for a, b in pairs:
        assert os.path.relpath(a, caches[0]) == os.path.relpath(b, caches[1])
        _same_files(a, b)


def test_heldout_sweep_matches_jax(caches):
    got = scale.heldout_sweep(4, 60_000, coverages=[0.2, 2.0], seed=1,
                              out_csv=str(caches[0] / "sweep.csv"),
                              opt=Options(lagrangian_rounds=2),
                              with_baseline=True, target_runs=1,
                              device="cpu")
    want = jscale.heldout_sweep(4, 60_000, coverages=[0.2, 2.0], seed=1,
                                out_csv=str(caches[1] / "sweep.csv"),
                                opt=JaxOptions(lagrangian_rounds=2),
                                with_baseline=True, target_runs=1)
    assert [(c.read_name, c.coverage) for c in got] == \
        [(c.read_name, c.coverage) for c in want]
    for a, b in zip(got, want):
        assert _untimed(dataclasses.asdict(a)) == \
            _untimed(dataclasses.asdict(b))
    by = {(c.read_name, c.coverage): c for c in got}
    assert by[("heldout", "2x")].edit_distance < \
        by[("heldout", "0.2x")].edit_distance
    assert by[("besthap", "2x")].edit_distance > \
        by[("heldout", "2x")].edit_distance
    # the '(time, rss, edit)' cells with their times and RSS masked
    port, ref = (re.sub(r"\(([\d.]+), ([\d.]+), ", "(T, M, ",
                        (d / "sweep.csv").read_text()) for d in caches)
    assert port == ref
    assert port.startswith("Reads,0.2x,2x\nbesthap,")


def test_bench_sketch_and_join_match_jax():
    got = throughput.bench_sketch(200_000, repeats=1)
    want = jthroughput.bench_sketch(200_000, repeats=1)
    assert list(got) == list(want)
    assert _untimed(got) == _untimed(want)
    assert got["spectrum"] > 0
    got = throughput.bench_join(200_000, repeats=1, device="cpu")
    want = jthroughput.bench_join(200_000, repeats=1)
    assert list(got) == list(want)
    assert _untimed(got) == _untimed(want)
    assert got["hits"] > 0


def test_join_plan_of_one_64_mbp_sequence():
    """bench_join at its default size: one 64 Mbp sequence is 31 rows of at
    most one super-row of windows, covering every window once, in 4 batches
    whose caps hold the expected emissions and the hits of a 4 Mbp
    spectrum."""
    from phi_tpu_torch.sketch import kernels as tk
    k, w, L = 31, 25, 64_000_000
    results, rows = tk.plan_join_rows([np.zeros(L, np.uint8)], k, w)
    assert results == [None] and len(rows) == 31
    sup = tk.SUPER_BLOCKS * tk.BLK
    assert all(n <= sup for _, _, n, _ in rows)
    assert sum(n for _, _, n, _ in rows) == L - (k + w - 2)
    assert [s for _, s, _, _ in rows] == list(range(0, L - k - w + 2, sup))
    assert -(-len(rows) // tk.ROWS) == 4
    assert tk.emit_cap(w) > 2 * sup // (w + 1) * 1.25
    assert tk.hit_cap(w) > 2 * (1 << 22) // (w + 1)


def _json_lines(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_scale_cli_json_matches_jax(caches, capsys):
    args = ["--haps", "3", "--length", "20000", "--coverage", "2", "--runs",
            "2"]
    assert scale.main(args + ["--device", "cpu", "--out-csv",
                              str(caches[0] / "s.csv")]) == 0
    got = _json_lines(capsys.readouterr().out)
    assert jscale.main(args + ["--out-csv", str(caches[1] / "s.csv")]) == 0
    want = _json_lines(capsys.readouterr().out)
    assert len(got) == len(want) == 1
    assert list(got[0]) == list(want[0])
    assert _untimed(got[0]) == _untimed(want[0])
    assert got[0]["n_runs"] == 2 and len(got[0]["wall_raw_s"]) == 2
    masked = (2, 3, 4, 9)
    assert _masked_rows(str(caches[0] / "s.csv"), masked) == \
        _masked_rows(str(caches[1] / "s.csv"), masked)


def test_throughput_cli_json_matches_jax(capsys):
    args = ["--mbases", "0.2", "--repeats", "1"]
    assert throughput.main(args + ["--device", "cpu"]) == 0
    got = _json_lines(capsys.readouterr().out)
    assert jthroughput.main(args) == 0
    want = _json_lines(capsys.readouterr().out)
    assert [r["metric"] for r in got] == [r["metric"] for r in want] == \
        ["sketch", "join"]
    for a, b in zip(got, want):
        assert list(a) == list(b)
        assert {k: v for k, v in _untimed(a).items() if k != "device"} == \
            {k: v for k, v in _untimed(b).items() if k != "device"}
        assert (a["backend"], a["device"]) == ("cpu", "cpu")


def test_throughput_roofline_on_cuda_only():
    assert throughput._roofline("cpu", 1e9) == {}
    r = throughput._roofline("cuda", 1.34e12)
    assert r == {"hbm_roofline_bases_per_s": 13_400_000_000_000,
                 "hbm_roofline_fraction": 0.1}


@pytest.mark.parametrize("cli", ["scale", "throughput"])
def test_cli_cuda_without_card_exits_1(caches, capsys, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = scale if cli == "scale" else throughput
    args = (["--haps", "3", "--length", "20000"] if cli == "scale"
            else ["--mbases", "0.2"])
    assert mod.main(args) == 1
    captured = capsys.readouterr()
    assert captured.err.startswith("[E::main]") and "no CUDA device" in \
        captured.err
    assert captured.out == ""
    assert not os.path.exists(caches[0])  # no instance was built


def test_throughput_mesh_is_refused(capsys):
    """--mesh 2 is refused on cuda without two visible cards; on the CPU
    it adds phi_tpu's sketch@2dev record, the same spectrum as its
    single-device sketch."""
    if torch.cuda.device_count() < 2:
        assert throughput.main(["--mbases", "0.2", "--mesh", "2"]) == 1
        err = capsys.readouterr().err
        assert err.startswith("[E::main]") and "CUDA device" in err
    args = ["--mbases", "0.2", "--repeats", "1", "--mesh", "2"]
    assert jthroughput.main(args) == 0
    want = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert throughput.main(args + ["--device", "cpu"]) == 0
    got = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["metric"] for r in got] == [r["metric"] for r in want] == \
        ["sketch", "join", "sketch@2dev"]
    assert got[2]["spectrum"] == want[2]["spectrum"] == got[0]["spectrum"]
