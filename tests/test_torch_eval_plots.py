"""The port's eval.plots against phi_tpu's on the CPU: `read_matrix_csv`
equal on every bench_results/*.csv (read only; where phi_tpu's raises, the
port's raises the same error), the figures drawn (PNGs over 1000 B) by
`plot_matrix`, `plot_scaling` and the CLI, tests/test_eval.py's two plot
cases, and a module that imports matplotlib only to draw."""

import glob
import os
import subprocess
import sys

import pytest

pytest.importorskip("jax")
pytest.importorskip("matplotlib")

import phi_tpu.eval.plots as jplots  # noqa: E402
from phi_tpu_torch.eval import plots  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSVS = sorted(glob.glob(os.path.join(REPO, "bench_results", "*.csv")))


@pytest.mark.parametrize("path", CSVS, ids=os.path.basename)
def test_read_matrix_csv_matches_jax(path):
    try:
        want = jplots.read_matrix_csv(path)
    except Exception as e:  # a CSV of another shape: both refuse it alike
        with pytest.raises(type(e)):
            plots.read_matrix_csv(path)
        return
    assert plots.read_matrix_csv(path) == want


def test_most_records_are_matrices():
    """The parametrized case above compares values on the matrix CSVs."""
    read = 0
    for path in CSVS:
        try:
            jplots.read_matrix_csv(path)
            read += 1
        except Exception:
            pass
    assert len(CSVS) >= 15 and read >= 6


def test_toy_matrix_of_test_eval(tmp_path):
    csv_path = tmp_path / "m.csv"
    csv_path.write_text(
        "Reads,0.1x,1x\n"
        "APD,\"(10.0, 1.00, 7551)\",\"(12.0, 1.10, 2220)\"\n"
        "DBB,\"(11.0, 1.05, 9000)\",\"(13.0, 1.20, 2500)\"\n")
    reads, covs, cells = plots.read_matrix_csv(str(csv_path))
    assert reads == ["APD", "DBB"] and covs == ["0.1x", "1x"]
    assert cells[("APD", "1x")] == (12.0, 1.10, 2220)
    assert (reads, covs, cells) == jplots.read_matrix_csv(str(csv_path))
    out = tmp_path / "fig.png"
    plots.plot_matrix(str(csv_path), str(out))
    assert out.stat().st_size > 1000
    assert plots.main([str(csv_path), str(tmp_path / "cli.png"),
                       "--metric", "0", "--ylabel", "s", "--linear"]) == 0
    assert (tmp_path / "cli.png").stat().st_size > 1000


@pytest.mark.parametrize("name", ["heldout_r02b.csv", "heldout_49x5M_r02.csv",
                                  "leaveout_mhc_coverage_r02.csv"])
def test_plot_matrix_of_the_records(tmp_path, name):
    out = tmp_path / "fig.png"
    plots.plot_matrix(os.path.join(REPO, "bench_results", name), str(out))
    assert out.stat().st_size > 1000


@pytest.mark.parametrize("name", ["increasing_r03_cpu.csv",
                                  "increasing_r02_cpu.csv"])
def test_plot_scaling_of_the_records(tmp_path, name):
    """A CSV with median and IQR (error bars) and one with wall_s."""
    assert plots.REFERENCE_INCREASING == jplots.REFERENCE_INCREASING
    out = tmp_path / "fig.png"
    plots.plot_scaling(os.path.join(REPO, "bench_results", name), str(out),
                       reference=plots.REFERENCE_INCREASING)
    assert out.stat().st_size > 1000


def test_module_imports_no_matplotlib():
    code = ("import sys, phi_tpu_torch.eval.plots\n"
            "assert 'matplotlib' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
