"""VCF ingest: the port's converter against phi_tpu's on the CPU.

- `vcf_to_graph` gives equal GfaData arrays and equal `write_gfa` text on
  the fixtures of tests/test_vcfio.py (SNP, insertion, deletion,
  multi-allelic; a deletion over a SNP) and on a seeded random VCF with
  overlapping records (chip_smoke.py's `write_vcf`, whose `realize` must
  spell every converted walk).
- `python -m phi_tpu_torch.vcfio.vcf2graph` writes the JAX converter's GFA.
- Both packages' pipelines on a converted graph write byte-identical FASTAs.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from phi_tpu.config import Options as JaxOptions  # noqa: E402
from phi_tpu.io.gfa import write_gfa as jax_write_gfa  # noqa: E402
from phi_tpu.vcfio.vcf2graph import vcf_to_graph as jax_vcf_to_graph  # noqa: E402
from phi_tpu_torch.config import Options  # noqa: E402
from phi_tpu_torch.io.gfa import decode_seq, write_gfa  # noqa: E402
from phi_tpu_torch.pipeline import run_pipeline  # noqa: E402
from phi_tpu_torch.vcfio.vcf2graph import vcf_to_graph  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "ACGTTGCACAGTCAGTTGCATGCAACGGATTACA"


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fixture_basic(d):
    (d / "ref.fa").write_text(">chr1\n" + REF + "\n")
    (d / "v.vcf").write_text("\n".join([
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\tS2",
        "chr1\t5\t.\tT\tG\t.\tPASS\t.\tGT\t0|1\t1|1",
        "chr1\t12\t.\tT\tTAAA\t.\tPASS\t.\tGT\t1|0\t0|0",
        "chr1\t20\t.\tATG\tA\t.\tPASS\t.\tGT\t0|0\t1|0",
        "chr1\t29\t.\tA\tG,C\t.\tPASS\t.\tGT\t1|2\t0|1",
    ]) + "\n")
    return str(d / "v.vcf"), str(d / "ref.fa")


def _fixture_overlap(d):
    (d / "ref.fa").write_text(">chr\nAAACCCGGGTTTAAACCCGGGTTT\n")
    (d / "v.vcf").write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\tS2\n"
        "chr\t4\t.\tCCCGG\tC\t.\t.\t.\tGT\t1|0\t0|0\n"
        "chr\t6\t.\tC\tT\t.\t.\t.\tGT\t0|1\t0|0\n"
        "chr\t15\t.\tA\tG\t.\t.\t.\tGT\t1|1\t0|1\n"
        "chr\t20\t.\tG\t<DEL>\t.\t.\t.\tGT\t1|1\t0|1\n")
    return str(d / "v.vcf"), str(d / "ref.fa")


def _random_vcf(d, length=20_000, n_samples=4, seed=1):
    """chip_smoke.write_vcf at a small size, with overlaps every 20 sites."""
    ref_path, vcf_path = str(d / "rand.fa"), str(d / "rand.vcf")
    ref, records = _smoke().write_vcf(ref_path, vcf_path, length, n_samples,
                                      seed=seed, overlap_every=20)
    return vcf_path, ref_path, ref, records


def _assert_same_gfa(got, want):
    assert got.seg_names == want.seg_names
    assert got.walk_names == want.walk_names
    assert got.seg_tags == want.seg_tags and got.walk_meta == want.walk_meta
    for name in ("node_len", "node_off", "seq_code", "edge_u", "edge_v"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(got.walks) == len(want.walks)
    for a, b in zip(got.walks, want.walks):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert write_gfa(got) == jax_write_gfa(want)


@pytest.mark.parametrize("case,max_node_len", [
    ("basic", 30), ("basic", 5), ("basic", 6), ("overlap", 30),
    ("random", 30), ("random", 7)])
def test_vcf_to_graph_matches_jax(tmp_path, case, max_node_len):
    if case == "basic":
        vcf, ref = _fixture_basic(tmp_path)
    elif case == "overlap":
        vcf, ref = _fixture_overlap(tmp_path)
    else:
        vcf, ref, _, _ = _random_vcf(tmp_path)
    _assert_same_gfa(vcf_to_graph(vcf, ref, max_node_len=max_node_len),
                     jax_vcf_to_graph(vcf, ref, max_node_len=max_node_len))


def test_random_vcf_walks_spell_realized_haplotypes(tmp_path):
    """The smoke's VCF writer: REF and every sample haplotype walk spell
    what `realize` says, and overlapping records were written."""
    smoke = _smoke()
    vcf, ref_path, ref, records = _random_vcf(tmp_path)
    g = vcf_to_graph(vcf, ref_path)
    pos = np.array([p for p, *_ in records])
    ends = np.array([p + len(ra) for p, ra, _, _ in records])
    assert (pos[1:] < np.maximum.accumulate(ends)[:-1]).any()
    spell = {name: decode_seq(np.concatenate([g.node_seq_codes(v)
                                              for v in w.tolist()]))
             for name, w in zip(g.walk_names, g.walks)}
    assert spell["REF.0"] == ref
    assert len(g.walks) == 1 + 2 * 4
    for hap in range(8):
        assert spell[f"S{hap // 2}.{hap % 2}"] == \
            smoke.realize(ref, records, hap), hap


def test_vcf2graph_command_writes_jax_gfa(tmp_path):
    vcf, ref, _, _ = _random_vcf(tmp_path, length=5000)
    out = subprocess.run(
        [sys.executable, "-m", "phi_tpu_torch.vcfio.vcf2graph", "-v", vcf,
         "-r", ref, "-m", "12"], capture_output=True, text=True, cwd=REPO,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout == jax_write_gfa(
        jax_vcf_to_graph(vcf, ref, max_node_len=12))


def test_converted_graph_fasta_matches_jax(tmp_path):
    """Reads of a 2-switch mosaic of two sample haplotypes over a converted
    20 kbp graph of 9 walks: both pipelines write the same FASTA bytes."""
    from phi_tpu.pipeline import run_pipeline as jax_run
    from phi_tpu_torch.eval.synth import sample_reads
    smoke = _smoke()
    vcf, ref_path, ref, records = _random_vcf(tmp_path)
    gfa_path = str(tmp_path / "g.gfa")
    write_gfa(vcf_to_graph(vcf, ref_path), path=gfa_path)
    haps = [smoke.realize(ref, records, h) for h in (2, 5)]
    n = min(map(len, haps))
    rng = np.random.default_rng(7)
    reads, _ = sample_reads(rng, [h[:n] for h in haps], coverage=3.0,
                            read_len=150, error_rate=0.001,
                            recomb_breaks=[(n // 3, 1), (2 * n // 3, 0)])
    reads_path = str(tmp_path / "r.fa")
    with open(reads_path, "w") as f:
        f.writelines(f">r{i}\n{r}\n" for i, r in enumerate(reads))
    kw = dict(k=31, w=25, recombination=100)
    want = jax_run(gfa_path, reads_path, str(tmp_path / "jax.fa"),
                   JaxOptions(**kw))
    got = run_pipeline(gfa_path, reads_path, str(tmp_path / "port.fa"),
                       Options(**kw), device="cpu")
    with open(tmp_path / "jax.fa", "rb") as a, \
            open(tmp_path / "port.fa", "rb") as b:
        assert a.read() == b.read()
    assert got.report_segments == want.report_segments
    assert got.decode.true_objective == pytest.approx(
        want.decode.true_objective, abs=1e-4)
