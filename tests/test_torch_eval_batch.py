"""The port's matrix runner and its helpers against phi_tpu's on the CPU:

- `summarize` and `run_stats` (eval/stats.py) on fixed time lists;
- `scrape_log` on the fixed log of tests/test_eval.py and on the stderr of
  a port CLI run against a phi_tpu CLI run of the same instance (every
  field but the times and the RSS);
- `downsample_fastq`: the same bytes and the same count;
- `edit_stats_files` and `truth_vs_panel`;
- `run_matrix` on a 4 x 20 kbp instance with two cells (its reads and a
  0.5 titration): every field of every cell but the wall times and the
  RSS, and both CSVs with those columns masked;
- `run_matrix` on cuda without a card raises.
"""

import dataclasses
import gzip
import re

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from phi_tpu.config import Options as JaxOptions  # noqa: E402
from phi_tpu.eval import batch as jbatch  # noqa: E402
from phi_tpu.eval import edits as jedits  # noqa: E402
from phi_tpu.eval import stats as jstats  # noqa: E402
from phi_tpu.eval.scrape import scrape_log as jax_scrape_log  # noqa: E402
from phi_tpu_torch.config import Options  # noqa: E402
from phi_tpu_torch.eval import batch, edits, scrape_log, stats  # noqa: E402

TIMES = [[1.0], [3.2, 1.1, 2.05], [5.0, 4.0, 3.0, 2.0, 1.0, 0.5],
         [0.1234, 0.1235, 0.1236, 10.0], [2.5, 2.5]]
# the wall and RSS fields of the records: not compared
TIME_FIELDS = {"real_time_s", "peak_rss_gb", "time_iqr_s", "raw_times_s"}
TIME_KEYS = {"real_time", "cpu_time", "peak_rss_gb"}

FIXED_LOG = """
[M::ILP_function::56.481*3.51] Indexed reads with spectrum size: 138834
[M::ILP_function::57.199*3.48] Filtered/Retained Minimizers: 77.07/22.93%
[M::ILP_function::57.199*3.48] 14.92% Minimizers are in ILP
[M::ILP_function::65.223*3.20] DP sweeps: 4; lower bound: 77.000; path objective: 77.000; gap: 0.000
Recombination count: 0
Recombined haplotypes: >(CHM13.0,[0,4920302])
[M::ILP_function::65.341*3.20] Haplotype of size: 4920303 written to: /tmp/x.fa
[M::main] Real time: 65.341 sec; CPU: 209.1 sec; Peak RSS: 3.211 GB
"""


@pytest.mark.parametrize("times", TIMES, ids=lambda t: f"n{len(t)}")
def test_summarize_matches_jax(times):
    assert stats.summarize(times) == jstats.summarize(times)


def test_run_stats_runs_and_stops_as_jax(monkeypatch):
    """target_runs caps the repeats; a first run above cheap_wall_s stops
    after min_runs (a fake clock, the same in both packages)."""
    for mod in (stats, jstats):
        clock = iter(np.arange(0.0, 1000.0, 7.0))
        monkeypatch.setattr(mod.time, "time", lambda: float(next(clock)))
        calls = []
        res, st = mod.run_stats(lambda: calls.append(1) or len(calls),
                                target_runs=4)
        assert (res, st["n_runs"]) == (4, 4)
        res, st = mod.run_stats(lambda: 9, target_runs=4, cheap_wall_s=5.0)
        assert (res, st["n_runs"]) == (9, 1)


def test_scrape_fixed_log_matches_jax():
    d = scrape_log(FIXED_LOG)
    assert d == jax_scrape_log(FIXED_LOG)
    assert d["spectrum_size"] == 138834
    assert d["recombined_haplotypes"] == ">(CHM13.0,[0,4920302])"
    assert d["dp_gap"] == 0.0


@pytest.fixture(scope="module")
def instance(tmp_path_factory):
    """A 4 x 20 kbp instance (the generator of both packages writes the
    same files) and a 0.5 titration of its reads."""
    from phi_tpu_torch.eval import scale
    d = tmp_path_factory.mktemp("inst")
    old = scale.CACHE_DIR
    scale.CACHE_DIR = str(d)
    try:
        paths = scale.build_instance(4, 20_000, coverage=2.0, seed=3,
                                     n_breaks=1)
    finally:
        scale.CACHE_DIR = old
    half = str(d / "half.fq.gz")
    batch.downsample_fastq(paths["reads"], half, 0.5, seed=11)
    return paths, half


def test_scrape_port_run_matches_jax_run(instance, tmp_path, capsys):
    """The port's CLI writes the [M::] lines phi_tpu's writes: the scraped
    records of the two runs agree in every field but the times and RSS."""
    from phi_tpu.cli import main as jax_main
    from phi_tpu_torch.cli import main
    paths, _ = instance
    args = ["-g", paths["gfa"], "-r", paths["reads"], "-k", "15", "-w", "5"]
    assert main(args + ["-o", str(tmp_path / "p.fa"), "--device", "cpu"]) == 0
    port = scrape_log(capsys.readouterr().err)
    assert jax_main(args + ["-o", str(tmp_path / "j.fa")]) == 0
    ref = jax_scrape_log(capsys.readouterr().err)
    assert set(port) == set(ref)
    assert TIME_KEYS <= set(port)
    assert {k: v for k, v in port.items() if k not in TIME_KEYS} == \
        {k: v for k, v in ref.items() if k not in TIME_KEYS}
    assert port["spectrum_size"] > 0 and port["haplotype_size"] > 0


@pytest.mark.parametrize("fraction,seed", [(0.25, 3), (0.5, 11), (1.0, 0)])
def test_downsample_fastq_matches_jax(tmp_path, fraction, seed):
    src = tmp_path / "r.fq.gz"
    with gzip.open(src, "wt") as f:
        for i in range(400):
            f.write(f"@r{i}\nACGTACGTAC\n+\nIIIIIIIIII\n")
    out, jout = tmp_path / "s.fq", tmp_path / "j.fq"
    kept = batch.downsample_fastq(str(src), str(out), fraction, seed=seed)
    assert kept == jbatch.downsample_fastq(str(src), str(jout), fraction,
                                           seed=seed)
    assert out.read_bytes() == jout.read_bytes()
    assert len(out.read_text().splitlines()) == 4 * kept
    assert list(batch.fastq_records(str(out))) == \
        list(jbatch.fastq_records(str(jout)))


def test_edit_helpers_match_jax(tmp_path):
    (tmp_path / "t.fa.gz").write_bytes(gzip.compress(b">t\nACGTAC\nGTAC\n>u\nTT\n"))
    (tmp_path / "p1.fa").write_text(">p1\nACGTACGTAC\n")
    (tmp_path / "p2.fa").write_text(">p2\nACGAACGTAC\n")
    t, p = str(tmp_path / "t.fa.gz"), [str(tmp_path / "p1.fa"),
                                      str(tmp_path / "p2.fa")]
    assert edits._read_fasta_first_seq(t) == "ACGTACGTAC"
    assert dataclasses.asdict(edits.edit_stats_files(p[1], t)) == \
        dataclasses.asdict(jedits.edit_stats_files(p[1], t))
    assert edits.truth_vs_panel(t, p) == jedits.truth_vs_panel(t, p)
    assert edits.truth_vs_panel(t, []) == jedits.truth_vs_panel(t, [])


def _masked_csv(text: str) -> str:
    """A matrix CSV with its times and RSS masked: the '(time, rss, edit)'
    cells of the grid, and the time and RSS columns of the stats CSV."""
    text = re.sub(r"\(([\d.]+), ([\d.]+), ", "(T, M, ", text)
    rows = [ln.split(",") for ln in text.splitlines()]
    if rows and rows[0][0] == "read":
        for r in rows[1:]:
            r[3:8] = ["T"] * 5
            r[10] = "T"
    return "\n".join(",".join(r) for r in rows)


@pytest.fixture(scope="module")
def matrices(instance, tmp_path_factory):
    paths, half = instance
    d = tmp_path_factory.mktemp("matrix")
    cells = [("sim", "2x", paths["reads"], paths["truth"]),
             ("sim", "1x", half, paths["truth"])]
    port = batch.run_matrix(paths["gfa"], cells,
                            Options(k=15, w=5, lagrangian_rounds=2),
                            out_csv=str(d / "port.csv"), target_runs=2,
                            device="cpu")
    ref = jbatch.run_matrix(paths["gfa"], cells,
                            JaxOptions(k=15, w=5, lagrangian_rounds=2),
                            out_csv=str(d / "jax.csv"), target_runs=2)
    return port, ref, d


def test_run_matrix_matches_jax(matrices):
    port, ref, _ = matrices
    assert len(port) == len(ref) == 2
    for a, b in zip(port, ref):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            if f.name not in TIME_FIELDS:
                assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert a.n_runs == 2 and len(a.raw_times_s) == 2
    assert port[0].edit_distance <= port[1].edit_distance


@pytest.mark.parametrize("suffix", [".csv", ".csv.stats.csv"])
def test_run_matrix_csv_matches_jax(matrices, suffix):
    _, _, d = matrices
    text = (d / f"port{suffix}").read_text()
    assert _masked_csv(text) == _masked_csv((d / f"jax{suffix}").read_text())
    assert text.startswith("Reads,1x,2x" if suffix == ".csv" else "read,")


def test_run_matrix_cuda_without_card_raises(instance):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    paths, _ = instance
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.run_matrix(paths["gfa"], [("sim", "2x", paths["reads"],
                                         paths["truth"])], target_runs=1)
