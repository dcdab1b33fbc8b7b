"""`-d` and `--race` on the port's CLI, against phi_tpu on the CPU.

- `-d 1`: the k-mer sharing histogram, the model dump and the chosen
  path's `[D]` lines are identical between the packages, on a small
  mosaic (a full dump), at k = 35, on a graph with a chain of empty nodes
  (bracket mode) and on a model past the dump's size caps (its summary
  line).
- `--race on|off|auto` is accepted and does nothing but log one line.
- `--mesh` on the CPU: `--device cpu --mesh 2` writes phi's `--mesh`
  FASTA; `--device cuda --mesh 2` without two cards is rejected with
  `[E::main]`.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from phi_tpu.config import Options as JaxOptions  # noqa: E402
from phi_tpu_torch.config import Options  # noqa: E402
from phi_tpu_torch.eval.synth import sample_reads, synth_pangenome  # noqa: E402
from phi_tpu_torch.io.gfa import write_gfa  # noqa: E402
from phi_tpu_torch.pipeline import run_pipeline  # noqa: E402

from test_torch_bracket import _chain_instance  # noqa: E402


def _mosaic(d, n_haps=4, length=2000, seed=3):
    rng = np.random.default_rng(seed)
    gfa_data, hap_seqs = synth_pangenome(rng, length=length, n_haps=n_haps,
                                         indel_fraction=0.1)
    reads, _ = sample_reads(rng, hap_seqs, coverage=4.0, read_len=100,
                            error_rate=0.002,
                            recomb_breaks=[(length // 2, 1)])
    gfa_path, reads_path = str(d / "g.gfa"), str(d / "r.fa")
    write_gfa(gfa_data, path=gfa_path)
    with open(reads_path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    return gfa_path, reads_path


def _debug_lines(err: str) -> list[str]:
    return [ln for ln in err.splitlines()
            if ln.startswith(("[D]", "[Haplotypes:", "Shared fraction"))]


@pytest.mark.parametrize("case", ["mosaic", "chain", "large", "wide"])
def test_debug_lines_match_jax(tmp_path, capfd, case):
    from phi_tpu.pipeline import run_pipeline as jax_run
    if case == "wide":  # k > 31: the walks are sketched by the native scan
        gfa_path, reads_path = _mosaic(tmp_path)
        kw = dict(k=35, w=11, recombination=5)
    elif case == "chain":
        gfa_path, reads_path = _chain_instance(tmp_path, 80, all_walks=True)
        kw = dict(k=15, w=5, recombination=10)
    elif case == "large":
        gfa_path, reads_path = _mosaic(tmp_path, n_haps=3, length=200_000)
        kw = dict(k=21, w=11)
    else:
        gfa_path, reads_path = _mosaic(tmp_path)
        kw = dict(k=11, w=5, recombination=5)
    capfd.readouterr()
    jax_run(gfa_path, reads_path, str(tmp_path / "jax.fa"),
            JaxOptions(debug=True, **kw))
    want = _debug_lines(capfd.readouterr().err)
    got_res = run_pipeline(gfa_path, reads_path, str(tmp_path / "port.fa"),
                           Options(debug=True, **kw), device="cpu")
    got = _debug_lines(capfd.readouterr().err)
    assert got == want
    hist = [float(ln.split(": ")[-1].rstrip("]")) for ln in got
            if ln.startswith("[Haplotypes:")]
    assert len(hist) == got_res.graph.num_walks
    assert sum(hist) == pytest.approx(1.0, abs=1e-4)
    skipped = any("model dump skipped (too large)" in ln for ln in got)
    assert skipped == (case == "large")
    assert sum(ln.startswith("[D] segment") for ln in got) >= 1


@pytest.mark.parametrize("race", ["on", "off", "auto"])
def test_cli_race_is_accepted(tmp_path, capfd, race):
    from phi_tpu_torch.cli import main
    gfa_path, reads_path = _mosaic(tmp_path)
    out = tmp_path / "o.fa"
    rc = main(["-g", gfa_path, "-r", reads_path, "-o", str(out), "-k", "11",
               "-w", "5", "--device", "cpu", "--race", race])
    err = capfd.readouterr().err
    assert rc == 0, err[-2000:]
    assert out.exists()
    assert f"--race {race}: no effect" in err


def test_cli_mesh_still_rejected(tmp_path, capfd, monkeypatch):
    """--mesh 2 is rejected on cuda without two visible cards (the CLI
    never runs a mesh on fewer cards than asked), and on the CPU runs two
    shards, writing phi's --mesh FASTA."""
    from phi_tpu.pipeline import run_pipeline as jax_run
    from phi_tpu_torch.cli import main
    gfa_path, reads_path = _mosaic(tmp_path)
    argv = ["-g", gfa_path, "-r", reads_path, "-k", "11", "-w", "5",
            "--mesh", "2"]
    if torch.cuda.device_count() < 2:
        assert main(argv + ["-o", str(tmp_path / "o.fa")]) == 1
        err = capfd.readouterr().err
        assert "[E::main]" in err and "CUDA device" in err
        assert not (tmp_path / "o.fa").exists()
    monkeypatch.setenv("PHI_TPU_FORCE_DEVICE_SOLVE", "1")
    jax_run(gfa_path, reads_path, str(tmp_path / "jax.fa"),
            JaxOptions(k=11, w=5, mesh_devices=2))
    assert main(argv + ["-o", str(tmp_path / "port.fa"), "--device",
                        "cpu"]) == 0
    with open(tmp_path / "jax.fa", "rb") as a, \
            open(tmp_path / "port.fa", "rb") as b:
        assert a.read() == b.read()
