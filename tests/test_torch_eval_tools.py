"""The port's eval.datasets and eval.competitors against phi_tpu's on the
CPU: tests/test_eval.py::test_datasets_native_steps and
tests/test_competitors.py, each run through both packages with the same
stub executables, PATH holding only the stubs (no real download tool is
ever found), and `build_mhc_dataset` driven by a recording runner that
runs nothing: the reports, the argv lists, the written files and the
results are equal."""

import dataclasses
import os
import stat
import textwrap

import numpy as np
import pytest

pytest.importorskip("jax")

import phi_tpu.eval.competitors as jcomp  # noqa: E402
import phi_tpu.eval.datasets as jdata  # noqa: E402
from phi_tpu_torch.eval import competitors, datasets  # noqa: E402

PKGS = {"port": (datasets, competitors), "jax": (jdata, jcomp)}


def _write_exe(path, body):
    with open(path, "w") as f:
        f.write("#!/bin/sh\n" + textwrap.dedent(body))
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)


def _tree(root) -> dict:
    """Every file under root: relative path -> bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _fastq(path, n, seed, length=None):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            m = length or int(rng.integers(80, 160))
            seq = "".join(rng.choice(list("ACGT"), m))
            f.write(f"@r{i}\n{seq}\n+\n{'I' * m}\n")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_datasets_native_steps(tmp_path, pkg):
    """tests/test_eval.py::test_datasets_native_steps, through each
    package."""
    mod = PKGS[pkg][0]
    fa = tmp_path / "MHC-CHM13.0.fa"
    fa.write_text(">CHM13#0\nACGT\n")
    mod.rename_chm13_header(str(fa))
    assert fa.read_text() == ">0\nACGT\n"
    fq = tmp_path / "APD.fastq"
    _fastq(fq, 200, 0, length=100)
    assert mod.mean_read_length(str(fq)) == 100.0
    out = tmp_path / "s.fastq"
    assert mod.sample_n_reads(str(fq), str(out), 50, seed=1) == 50
    lines = out.read_text().strip().split("\n")
    assert len(lines) == 200
    ids = [int(ln[2:]) for ln in lines[::4]]
    assert ids == sorted(ids)
    produced = mod.downsample_by_coverage(str(tmp_path), str(tmp_path / "ds"),
                                          samples=["APD"],
                                          coverages=[0.1, 15],
                                          region_len=10_000)
    assert len(produced) == 2
    low = (tmp_path / "ds" / "APD_0.1x.fastq").read_text().strip().split("\n")
    assert len(low) == 4 * 10
    full = (tmp_path / "ds" / "APD_15x.fastq").read_text().strip().split("\n")
    assert len(full) == 4 * 200


def test_native_steps_write_the_same_files(tmp_path):
    """The header rewrite (gzip too), the mean length, the reservoir sample
    and the titration of mixed-length reads: equal values and bytes."""
    got = {}
    for pkg, (mod, _) in PKGS.items():
        d = tmp_path / pkg
        (d / "reads").mkdir(parents=True)
        fa = d / "MHC-CHM13.0.fa"
        fa.write_text(">CHM13#0\nACGT\n>other\nTT\n")
        mod.rename_chm13_header(str(fa))
        for s, seed in (("APD", 1), ("DBB", 2)):
            _fastq(d / "reads" / f"{s}.fastq", 300, seed)
        mean = mod.mean_read_length(str(d / "reads" / "APD.fastq"))
        kept = mod.sample_n_reads(str(d / "reads" / "DBB.fastq"),
                                  str(d / "s.fastq.gz"), 77, seed=5)
        produced = mod.downsample_by_coverage(
            str(d / "reads"), str(d / "ds"), coverages=[0.1, 1, 15],
            region_len=20_000)
        got[pkg] = (mean, kept, [os.path.relpath(p, d) for p in produced])
    assert got["port"] == got["jax"]
    assert got["port"][2] == [f"ds/{s}_{c}x.fastq" for s in ("APD", "DBB")
                              for c in ("0.1", "1", "15")]
    port, jax = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    import gzip
    for tree in (port, jax):
        tree["s.fastq.gz"] = gzip.decompress(tree["s.fastq.gz"])
    assert port == jax


def _stub_tools(bindir, names):
    bindir.mkdir(exist_ok=True)
    for n in names:
        _write_exe(bindir / n, "exit 0\n")


def _recording_runner(calls, out_dir):
    """Records each argv (out_dir written as <out>) and runs nothing; a
    fastq-dump call leaves two split FASTQ files as the tool would."""
    def runner(argv, check=False):
        calls.append([a.replace(out_dir, "<out>") for a in argv])
        if argv[0] == "fastq-dump":
            blob = argv[-1]
            reads_dir = argv[argv.index("--outdir") + 1]
            stem = os.path.basename(blob).replace(".sra", "")
            seed = sum(map(ord, stem))
            for part in (1, 2):
                _fastq(os.path.join(reads_dir, f"{stem}_{part}.fastq"), 60,
                       seed + part)
    return runner


def test_build_mhc_dataset_matches_jax(tmp_path, monkeypatch):
    """Every tool on PATH (stubs): each step reports done, the same argv
    lists in the same order, the merged reads and titrations equal."""
    bindir = tmp_path / "bin"
    _stub_tools(bindir, ["wget", "agc", "cactus-pangenome", "fastq-dump"])
    monkeypatch.setenv("PATH", str(bindir))
    got = {}
    for pkg, (mod, _) in PKGS.items():
        out_dir = str(tmp_path / pkg)
        calls = []
        report = mod.build_mhc_dataset(out_dir, threads=3,
                                       runner=_recording_runner(calls,
                                                                out_dir))
        got[pkg] = (report, calls, _tree(out_dir))
    assert got["port"] == got["jax"]
    report, calls, tree = got["port"]
    assert report["panel"] == report["pangenome"] == report["reads"] == "done"
    assert report["downsample"] == "done (35 files)"
    assert [c[0] for c in calls] == (["wget", "agc", "cactus-pangenome"]
                                     + ["wget", "fastq-dump"] * 5)
    assert "reads/APD.fastq" in tree and "reads/APD_1.fastq" not in tree


def test_build_mhc_dataset_skips_without_tools(tmp_path, monkeypatch):
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    reports = []
    for pkg, (mod, _) in PKGS.items():
        calls = []
        reports.append(mod.build_mhc_dataset(
            str(tmp_path / pkg), runner=_recording_runner(calls, "")))
        assert calls == []
    assert reports[0] == reports[1]
    assert reports[0]["panel"] == "skipped (wget/agc not on PATH)"
    assert reports[0]["downsample"] == "skipped (no read sets present)"


def test_datasets_cli_matches_jax(tmp_path, monkeypatch, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    assert datasets.main(["-o", str(tmp_path / "d")]) == 0
    got = capsys.readouterr().out
    assert jdata.main(["-o", str(tmp_path / "d")]) == 0
    assert got == capsys.readouterr().out
    assert datasets.SRA_RUNS == jdata.SRA_RUNS
    assert (datasets.COVERAGES, datasets.REGION_LEN, datasets.PANEL_URL) == \
        (jdata.COVERAGES, jdata.REGION_LEN, jdata.PANEL_URL)


@pytest.mark.parametrize("seq", ["ACGTN", "GATTACA", "acgtnNNA", ""])
def test_revcomp(seq):
    assert competitors.revcomp(seq) == jcomp.revcomp(seq)
    assert competitors.revcomp(competitors.revcomp(seq)) == seq


def test_hom_consensus_matches_jax(tmp_path):
    ref = tmp_path / "ref.fa"
    ref.write_text(">chr1\nACGTACGTACGT\n")
    vcf = tmp_path / "g.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        "chr1\t2\t.\tC\tT\t.\t.\t.\tGT\t1/1\n"    # hom SNP -> applied
        "chr1\t5\t.\tA\tG\t.\t.\t.\tGT\t0/1\n"    # het -> skipped
        "chr1\t7\t.\tGT\tG\t.\t.\t.\tGT\t1/1\n"   # hom deletion -> applied
        "chr1\t8\t.\tT\tA\t.\t.\t.\tGT\t1/1\n")   # overlaps deletion -> skipped
    got = competitors.hom_consensus(str(vcf), str(ref),
                                    str(tmp_path / "port.fa"))
    want = jcomp.hom_consensus(str(vcf), str(ref), str(tmp_path / "jax.fa"))
    assert got == want == (4, 3, 1)
    body = (tmp_path / "port.fa").read_text()
    assert body == (tmp_path / "jax.fa").read_text()
    assert "".join(ln.strip() for ln in body.splitlines()[1:]) == \
        "ATGTACGACGT"


def _untimed(res) -> dict:
    d = dataclasses.asdict(res)
    d.pop("wall_s")
    return d


def test_runners_skip_without_tools(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # an empty PATH dir
    for run in ("run_vg", "run_pangenie"):
        args = (("g.gbz", "r.fq", str(tmp_path / "o.fa")) if run == "run_vg"
                else ("r.fq", "ref.fa", "v.vcf", str(tmp_path / "o2.fa")))
        got = getattr(competitors, run)(*args)
        want = getattr(jcomp, run)(*args)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.skipped and ("vg" if run == "run_vg" else "PanGenie") \
            in got.skipped
    assert competitors.which_tools(["vg", "kmc"]) == \
        jcomp.which_tools(["vg", "kmc"]) == {"vg": None, "kmc": None}


def test_run_vg_stub_pipeline_matches_jax(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    calls = tmp_path / "calls.log"
    _write_exe(bindir / "vg", f"""\
        echo "vg $*" >> {calls}
        if [ "$1" = "paths" ]; then printf '>recombination\\nACGTTTGGCA\\n'; fi
        exit 0
        """)
    _write_exe(bindir / "kmc", f'echo "kmc $*" >> {calls}\nexit 0\n')
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    got = {}
    for pkg, (_, mod) in PKGS.items():
        out = tmp_path / f"{pkg}.fa"
        tmp = str(tmp_path / "tmp")
        log = tmp_path / f"{pkg}.log"
        res = mod.run_vg("graph.gbz", "reads.fq", str(out), threads=2,
                         tmp_dir=tmp, log_path=str(log))
        assert res.skipped is None and res.out_fa == str(out)
        got[pkg] = (out.read_text(), calls.read_text(), log.read_text())
        calls.unlink()
    assert got["port"] == got["jax"]
    fasta, argv, _ = got["port"]
    assert "".join(fasta.splitlines()[1:]) == competitors.revcomp("ACGTTTGGCA")
    assert [" ".join(ln.split()[:2]) for ln in argv.splitlines()] == \
        ["vg index", "vg gbwt", "vg haplotypes", "kmc -k29", "vg haplotypes",
         "vg paths"]


def test_run_pangenie_stub_and_matrix_match_jax(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    ref = tmp_path / "ref.fa"
    ref.write_text(">chr1\nACGTACGT\n")
    _write_exe(bindir / "PanGenie", """\
        prefix=""
        while [ $# -gt 0 ]; do
          if [ "$1" = "-o" ]; then prefix="$2"; fi
          shift
        done
        cat > "${prefix}_genotyping.vcf" <<'EOF'
##fileformat=VCFv4.2
#CHROM	POS	ID	REF	ALT	QUAL	FILTER	INFO	FORMAT	S
chr1	4	.	T	C	.	.	.	GT	1/1
EOF
        """)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    truth = tmp_path / "truth.fa"
    truth.write_text(">t\nACGTACGT\n")
    got = {}
    for pkg, (_, mod) in PKGS.items():
        out = tmp_path / f"pg_{pkg}.fa"
        log = tmp_path / f"pg_{pkg}.log"
        res = mod.run_pangenie("reads.fq", str(ref), "in.vcf", str(out),
                               log_path=str(log))
        assert res.skipped is None
        work = tmp_path / f"work_{pkg}"
        rows = mod.competitor_matrix(
            "PanGenie", [("S", "1x", "reads.fq", str(truth))],
            ref_path=str(ref), vcf_path="in.vcf",
            out_csv=str(tmp_path / f"{pkg}.csv"), work_dir=str(work))
        logs = sorted(os.listdir(work))
        with open(work / "rec_hap_S_1x_PanGenie.log") as f:
            matrix_log = [ln.replace(f"work_{pkg}", "work")
                          for ln in f.read().splitlines()]
        got[pkg] = (_untimed(res) | {"out_fa": None}, out.read_text(),
                    log.read_text().replace(f"pg_{pkg}", "pg").splitlines()[-1],
                    [dataclasses.asdict(r) | {"real_time_s": 0} for r in rows],
                    logs, matrix_log[-1])
        with pytest.raises(ValueError, match="unknown competitor"):
            mod.competitor_matrix("X", [("S", "1x", "r", str(truth))],
                                  work_dir=str(work))
    assert got["port"] == got["jax"]
    assert "".join(got["port"][1].splitlines()[1:]) == "ACGCACGT"
    assert got["port"][3][0]["edit_distance"] == 1
    assert got["port"][2] == ("Total variants: 1, Homozygous variants: 1, "
                              "Heterozygous variants: 0")
