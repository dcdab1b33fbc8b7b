"""End to end: the port's run_pipeline on CPU tensors against phi_tpu's
run_pipeline on its device path (Pallas in interpret mode, device solve),
on a plain mosaic, the Lagrangian refinement instance of test_solver and
the branch-and-bound paralog instance of test_bnb: a byte-identical FASTA,
the same recombination report, objectives within 1e-3 and the same
certified state. Plus the two CLIs as subprocesses, and a full port run
that never loads jax."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from phi_tpu.config import Options as JaxOptions  # noqa: E402
from phi_tpu.io.build import build_gfa_data  # noqa: E402
from phi_tpu.io.gfa import write_gfa  # noqa: E402
from phi_tpu_torch.config import Options  # noqa: E402
from phi_tpu_torch.pipeline import gap_tol, run_pipeline  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(tmp_path, gfa_data, reads):
    gfa_path = str(tmp_path / "graph.gfa")
    reads_path = str(tmp_path / "reads.fa")
    write_gfa(gfa_data, path=gfa_path)
    with open(reads_path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    return gfa_path, reads_path


def _mosaic(tmp_path):
    from phi_tpu.eval.synth import sample_reads, synth_pangenome
    rng = np.random.default_rng(11)
    gfa_data, hap_seqs = synth_pangenome(rng, length=7000, n_haps=4,
                                         indel_fraction=0.1)
    reads, _ = sample_reads(rng, hap_seqs, coverage=3.0, read_len=120,
                            error_rate=0.002,
                            recomb_breaks=[(2300, 2), (4800, 3)])
    return _write(tmp_path, gfa_data, reads)


def _refinement(tmp_path, seed=123):
    """tests/test_solver.py::test_refinement_closes_gap_random's instance
    (seed 123): a random bubble chain and one mosaic read. With seed 19 the
    root duality gap is open, so the Lagrangian rounds and the exact
    small-case enumeration run."""
    rng = random.Random(seed)
    bases = "ACGT"
    n_blocks, n_haps = 5, 3
    segments = {}
    walks_segs = [[] for _ in range(n_haps)]
    for b in range(n_blocks):
        segments[f"a{b}"] = "".join(rng.choice(bases)
                                    for _ in range(rng.randint(3, 6)))
        for h in range(n_haps):
            walks_segs[h].append(f"a{b}")
        if b < n_blocks - 1:
            alleles = []
            for a in range(rng.randint(1, 2)):
                name = f"v{b}_{a}"
                segments[name] = "".join(rng.choice(bases)
                                         for _ in range(rng.randint(2, 5)))
                alleles.append(name)
            for h in range(n_haps):
                walks_segs[h].append(alleles[rng.randrange(len(alleles))])
    h = rng.randrange(n_haps)
    read = ""
    for b in range(len(walks_segs[h])):
        if rng.random() < 0.3:
            h = rng.randrange(n_haps)
        read += segments[walks_segs[h][b]]
    walks = [(f"hap{h}.0", walks_segs[h]) for h in range(n_haps)]
    return _write(tmp_path, build_gfa_data(segments, walks), [read])


def _paralog(tmp_path, seed=1, mult=3):
    """tests/test_bnb.py::_paralog_graph: lane B repeats a motif the read
    carries once (duplicate k-mer credit, an open duality gap)."""
    rng = random.Random(seed)
    bases = "ACGT"
    motif = "ACGGTTCAAGGC"
    segments = {}
    A, B = [], []
    sid = 0

    def seg(seq):
        nonlocal sid
        out = []
        for i in range(0, len(seq), 5):
            segments[f"s{sid}"] = seq[i:i + 5]
            out.append(f"s{sid}")
            sid += 1
        return out

    shared0 = seg("TTACCGGATCAA")
    A += shared0
    B += shared0
    for _ in range(mult):
        A += seg("".join(rng.choice(bases) for _ in range(12)))
        B += seg(motif + rng.choice(bases))
    sharedN = seg("GGTTACAGCATT")
    A += sharedN
    B += sharedN
    read = "".join(segments[s] for s in A) + motif
    return _write(tmp_path, build_gfa_data(segments, [("A.0", A), ("B.0", B)]),
                  [read])


@pytest.fixture
def jax_device_path(monkeypatch):
    """phi_tpu on its device path (interpret-mode Pallas, device solve), at
    a small row geometry: results do not depend on it."""
    import phi_tpu.sketch.kernels as jk
    monkeypatch.setenv("PHI_TPU_FORCE_DEVICE_ANCHORS", "1")
    monkeypatch.setenv("PHI_TPU_FORCE_DEVICE_SOLVE", "1")
    monkeypatch.setattr(jk, "ROWS", 2)
    monkeypatch.setattr(jk, "SUPER_BLOCKS", 2)
    from phi_tpu.pipeline import run_pipeline as jax_run
    return jax_run


@pytest.mark.parametrize("case,kw", [
    (_mosaic, dict(recombination=5.0)),
    (_refinement, dict(k=4, w=2, recombination=1.0, lagrangian_rounds=6)),
    (lambda p: _refinement(p, seed=19),
     dict(k=4, w=2, recombination=1.0, lagrangian_rounds=6)),
    (_paralog, dict(k=8, w=3, recombination=100.0)),
], ids=["mosaic", "refinement", "refinement_open_gap", "paralog"])
def test_pipeline_matches_jax(tmp_path, jax_device_path, case, kw):
    gfa_path, reads_path = case(tmp_path)
    want = jax_device_path(gfa_path, reads_path, str(tmp_path / "jax.fa"),
                           JaxOptions(**kw))
    opt = Options(**kw)
    got = run_pipeline(gfa_path, reads_path, str(tmp_path / "torch.fa"),
                       opt, device="cpu")
    with open(tmp_path / "jax.fa", "rb") as a, \
            open(tmp_path / "torch.fa", "rb") as b:
        assert a.read() == b.read()
    assert got.recombination_count == want.recombination_count
    assert got.report_segments == want.report_segments
    assert got.decode.dp_objective == pytest.approx(
        want.decode.dp_objective, abs=1e-3)
    assert got.decode.true_objective == pytest.approx(
        want.decode.true_objective, abs=1e-3)
    tol = gap_tol(opt.recombination)
    assert (got.decode.true_objective - got.decode.dp_objective <= tol) == \
        (want.decode.true_objective - want.decode.dp_objective <= tol)
    assert got.anchors.n_model_kmers == want.anchors.n_model_kmers
    assert got.anchors.filtered_kmers == want.anchors.filtered_kmers
    assert set(want.timings) <= set(got.timings) | {"solve_decode"}


@pytest.mark.parametrize("case,k,w,R", [
    (lambda p: _paralog(p, seed=2, mult=4), 8, 3, 100.0),
    (lambda p: _refinement(p, seed=19), 4, 2, 1.0),
], ids=["paralog", "open_gap"])
def test_branch_and_bound_matches_jax(tmp_path, case, k, w, R):
    """The B&B escalation alone (no Lagrangian rounds): the same incumbent
    and certified bound."""
    from phi_tpu.anchors.join import build_anchor_tables, sketch_haplotypes
    from phi_tpu.graph import tensorize
    from phi_tpu.io.gfa import encode_seq, read_gfa
    from phi_tpu.sketch.minimizer import sketch_read_batch
    from phi_tpu.solve.bnb import branch_and_bound as jax_bnb
    from phi_tpu.solve.prep import solver_layers
    from phi_tpu_torch.anchors.join import AnchorTables
    from phi_tpu_torch.graph.pangenome import tensorize as port_tensorize
    from phi_tpu_torch.io.gfa import read_gfa as port_read_gfa
    from phi_tpu_torch.solve.bnb import branch_and_bound
    gfa_path, reads_path = case(tmp_path)
    graph = tensorize(read_gfa(gfa_path))
    with open(reads_path) as f:
        read = f.read().split("\n")[1]
    spectrum = sketch_read_batch(encode_seq(read)[None, :], k, w,
                                 np.array([len(read)], np.int32))
    anchors = build_anchor_tables(graph, k, sketch_haplotypes(graph, k, w),
                                  spectrum, 1.0)
    kw = dict(k=k, w=w, recombination=R, lagrangian_rounds=0)
    layers = solver_layers(graph, k)
    want, want_bound = jax_bnb(graph, anchors, JaxOptions(**kw), gap_tol(R),
                               layers=layers)
    port_anchors = AnchorTables(
        occ_hap=anchors.occ_hap, occ_start=anchors.occ_start,
        occ_end=anchors.occ_end, occ_kmer=anchors.occ_kmer,
        occ_weight=anchors.occ_weight, n_model_kmers=anchors.n_model_kmers,
        spectrum_size=anchors.spectrum_size,
        filtered_kmers=anchors.filtered_kmers,
        per_hap_minimizers=anchors.per_hap_minimizers,
        per_hap_anchors=anchors.per_hap_anchors)
    got, got_bound = branch_and_bound(
        port_tensorize(port_read_gfa(gfa_path)), port_anchors, Options(**kw),
        gap_tol(R), layers=layers, device=torch.device("cpu"))
    assert got.segments == want.segments
    assert got.true_objective == pytest.approx(want.true_objective, abs=1e-3)
    assert got_bound == pytest.approx(want_bound, abs=1e-3)


def test_branch_and_bound_defaults_to_the_card():
    """branch_and_bound runs its nodes on cuda unless the caller asks for
    the CPU: without a card, a call that names no device fails as every
    other entry point of the port does, instead of running on the CPU."""
    import inspect
    from phi_tpu_torch.solve.bnb import branch_and_bound
    param = inspect.signature(branch_and_bound).parameters["device"]
    assert param.default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            branch_and_bound(None, None, Options(), gap_tol(100.0))


def _report_lines(stderr: str) -> list[str]:
    return [ln for ln in stderr.splitlines()
            if ln.startswith(("Recombination count:",
                              "Recombined haplotypes:"))]


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600, **kw)


def test_cli_matches_jax_cli(tmp_path):
    gfa_path, reads_path = _mosaic(tmp_path)
    flags = ["-g", gfa_path, "-r", reads_path, "-R", "5"]
    want = _run(["-m", "phi_tpu.cli"] + flags
                + ["-o", str(tmp_path / "jax.fa"), "--race", "off"])
    got = _run(["-m", "phi_tpu_torch.cli"] + flags
               + ["-o", str(tmp_path / "torch.fa"), "--device", "cpu"])
    assert want.returncode == 0, want.stderr[-2000:]
    assert got.returncode == 0, got.stderr[-2000:]
    with open(tmp_path / "jax.fa", "rb") as a, \
            open(tmp_path / "torch.fa", "rb") as b:
        assert a.read() == b.read()
    assert _report_lines(got.stderr) == _report_lines(want.stderr)
    assert len(_report_lines(got.stderr)) == 2


def test_port_run_loads_no_jax(tmp_path):
    """conftest imports jax into this process, so the runs (the default k
    with -d 1, the wide k = 35, --save-index and --load-index, a --mesh 2
    run and one with the device read sketch, after importing the eval
    runners, the VCF converter and the mesh) are a child, which then holds
    neither jax nor any module of phi_tpu."""
    gfa_path, reads_path = _mosaic(tmp_path)
    idx = str(tmp_path / "index.npz")
    code = ("import sys\n"
            "import phi_tpu_torch.eval, phi_tpu_torch.trace\n"
            "import phi_tpu_torch.eval.frontier, phi_tpu_torch.vcfio.vcf2graph\n"
            "import phi_tpu_torch.eval.batch, phi_tpu_torch.eval.baselines\n"
            "import phi_tpu_torch.eval.crossval, phi_tpu_torch.eval.scale\n"
            "import phi_tpu_torch.eval.throughput, phi_tpu_torch.io.subset\n"
            "import phi_tpu_torch.parallel.dist, os\n"
            "import phi_tpu_torch.eval.groundtruth, phi_tpu_torch.eval.plots\n"
            "import phi_tpu_torch.eval.floor_diag, phi_tpu_torch.eval.merge_gt\n"
            "import phi_tpu_torch.eval.datasets\n"
            "import phi_tpu_torch.eval.competitors\n"
            "from phi_tpu_torch.cli import main\n"
            f"g = ['-g', {gfa_path!r}, '-o', {str(tmp_path / 'out.fa')!r}, "
            "'--device', 'cpu']\n"
            f"args = g + ['-r', {reads_path!r}]\n"
            "rc = (main(args + ['-d', '1']) + main(args + ['-k', '35'])\n"
            f"      + main(args + ['--save-index', {idx!r}])\n"
            f"      + main(g + ['--load-index', {idx!r}, '-R', '2'])\n"
            "      + main(args + ['--mesh', '2']))\n"
            "os.environ['PHI_TPU_DEVICE_READ_SKETCH'] = '1'\n"
            "rc += main(args + ['-k', '21'])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'phi_tpu'))\n"
            "print('rc', rc, 'loaded', bad)\n")
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "rc 0 loaded []" in res.stdout, res.stdout[-2000:]
    assert "Index saved to" in res.stderr
    assert "Loaded index from" in res.stderr


def test_cli_cuda_without_gpu_exits_1(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from phi_tpu_torch.cli import main
    gfa_path, reads_path = _mosaic(tmp_path)
    rc = main(["-g", gfa_path, "-r", reads_path, "-o",
               str(tmp_path / "out.fa"), "--device", "cuda"])
    assert rc == 1
    assert "[E::main]" in capsys.readouterr().err
    assert not (tmp_path / "out.fa").exists()


@pytest.mark.parametrize("flag", [["--mesh", "2"],
                                  ["--mesh", "2", "--race", "off"],
                                  ["--mesh", "4", "-d", "1"]])
def test_cli_rejects_unported_flags(tmp_path, capsys, flag):
    """--mesh, once refused, is ported: with --device cpu these flag sets
    run on N CPU shards and write phi's --mesh FASTA and report; with
    --device cuda and fewer cards than N the CLI still refuses, with
    [E::main], and writes no FASTA."""
    from phi_tpu.cli import main as jax_main
    from phi_tpu_torch.cli import main
    from phi_tpu_torch.sketch import kernels
    gfa_path, reads_path = _mosaic(tmp_path)
    base = ["-g", gfa_path, "-r", reads_path, "-R", "5"]
    if not torch.cuda.is_available():
        out = tmp_path / "cuda.fa"
        assert main(base + ["-o", str(out), "--device", "cuda"] + flag) == 1
        assert "[E::main]" in capsys.readouterr().err
        assert not out.exists()
    assert jax_main(base + ["-o", str(tmp_path / "jax.fa")] + flag) == 0
    want = capsys.readouterr().err
    prev = kernels.SUPER_BLOCKS
    kernels.SUPER_BLOCKS = 2  # a small join row: results do not depend on it
    try:
        rc = main(base + ["-o", str(tmp_path / "port.fa"), "--device",
                          "cpu"] + flag)
    finally:
        kernels.SUPER_BLOCKS = prev
    got = capsys.readouterr().err
    assert rc == 0, got[-2000:]
    with open(tmp_path / "jax.fa", "rb") as a, \
            open(tmp_path / "port.fa", "rb") as b:
        assert a.read() == b.read()

    def report(err):
        return [ln for ln in err.splitlines()
                if ln.startswith(("Recombin", "[Haplotypes:"))]
    assert report(got) == report(want) and report(got)
