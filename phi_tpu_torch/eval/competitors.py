"""Competitor runners: VG haplotype sampling and PanGenie, tool-gated.

The reference benchmarks PHI against vg's haplotype-sampling pipeline
(data/run_VG.py -> data/vg_haplotypes.py) and PanGenie (data/run_PG.py).
Neither tool ships with this framework; these runners reproduce the exact
command pipelines when the tools are on PATH and report a clear skip
otherwise, so the comparison matrix can be regenerated on any machine that
has them installed. The post-processing the reference delegates to
bcftools/seqtk/edlib (hom-genotype filtering, consensus, reverse
complement, edit distance) is implemented natively here, so only the
genotyper/sampler binaries themselves are required.

Reference citations: data/run_VG.py:41-62, data/vg_haplotypes.py:16-36,
data/run_PG.py:41-70. The port's copy of `phi_tpu/eval/competitors.py`
(host only: the competitors are external binaries).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import tempfile
import time

_COMP = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def revcomp(seq: str) -> str:
    """seqtk seq -r equivalent (vg_haplotypes.py:36)."""
    return seq.translate(_COMP)[::-1]


def which_tools(names: list[str]) -> dict[str, str | None]:
    return {n: shutil.which(n) for n in names}


def _run(cmd: list[str], log_path: str | None = None) -> None:
    with open(log_path, "ab") if log_path else open(os.devnull, "wb") as log:
        log.write((" ".join(cmd) + "\n").encode())
        log.flush()
        subprocess.run(cmd, check=True, stdout=log, stderr=log)


@dataclasses.dataclass
class CompetitorResult:
    tool: str
    out_fa: str | None
    wall_s: float
    skipped: str | None = None  # reason when the tool chain is unavailable


def run_vg(gbz_path: str, reads_path: str, out_fa: str, threads: int = 4,
           tmp_dir: str | None = None, log_path: str | None = None
           ) -> CompetitorResult:
    """The vg haplotype-sampling pipeline (vg_haplotypes.py:16-36):
    distance index -> r-index -> haplotype partitioning -> KMC read k-mer
    counting -> 1-haplotype sampling -> path FASTA -> reverse complement.
    Requires `vg` and `kmc` on PATH."""
    tools = which_tools(["vg", "kmc"])
    missing = [n for n, p in tools.items() if p is None]
    if missing:
        return CompetitorResult("VG", None, 0.0,
                                skipped=f"missing tools: {','.join(missing)}")
    t0 = time.time()
    own_tmp = tmp_dir is None
    tmp = tmp_dir or tempfile.mkdtemp(prefix="phi_vg_")
    os.makedirs(tmp, exist_ok=True)
    try:
        t = str(threads)
        _run(["vg", "index", "-j", f"{tmp}/temp.dist", gbz_path], log_path)
        _run(["vg", "gbwt", "-p", "--num-threads", t, "-r", f"{tmp}/temp.ri",
              "-Z", gbz_path], log_path)
        _run(["vg", "haplotypes", "-v", "2", "-t", t,
              "-H", f"{tmp}/temp.hapl", gbz_path], log_path)
        _run(["kmc", "-k29", "-m128", "-okff", f"-t{t}", "-hp",
              reads_path, f"{tmp}/sample", tmp], log_path)
        _run(["vg", "haplotypes", "-v", "2", "-t", t,
              "--num-haplotypes", "1", "-i", f"{tmp}/temp.hapl",
              "-k", f"{tmp}/sample.kff", "-g", f"{tmp}/sample.gbz",
              gbz_path], log_path)
        with open(f"{tmp}/paths.fa", "wb") as f:
            subprocess.run(["vg", "paths", "-x", f"{tmp}/sample.gbz",
                            "-F", "-S", "recombination"],
                           check=True, stdout=f)
        # seqtk seq -r analog: reverse-complement every record
        _revcomp_fasta(f"{tmp}/paths.fa", out_fa)
    finally:
        if own_tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    return CompetitorResult("VG", out_fa, time.time() - t0)


def _revcomp_fasta(in_fa: str, out_fa: str) -> None:
    from phi_tpu_torch.vcfio.vcf2graph import read_fasta
    seqs = read_fasta(in_fa)
    with open(out_fa, "w") as f:
        for name, seq in seqs.items():
            f.write(f">{name}\n")
            rc = revcomp(seq)
            for i in range(0, len(rc), 80):
                f.write(rc[i:i + 80] + "\n")


def hom_consensus(vcf_path: str, ref_path: str, out_fa: str,
                  contig: str | None = None) -> tuple[int, int, int]:
    """Native equivalent of the reference's PanGenie post-processing
    (run_PG.py:54-66): keep homozygous-genotyped records only
    (bcftools view -i 'GT="hom"'), apply their ALT alleles to the
    reference (bcftools consensus). Returns (total, hom, het) counts,
    the numbers run_PG.py echoes into its log."""
    from phi_tpu_torch.vcfio.vcf2graph import parse_vcf, read_fasta
    ctg, _samples, records = parse_vcf(vcf_path, contig)
    ref_seqs = read_fasta(ref_path)
    if ctg in ref_seqs:
        ref = ref_seqs[ctg]
    else:
        ref = next(iter(ref_seqs.values()))
    total = hom = 0
    parts: list[str] = []
    cursor = 0
    for rec in records:
        if not rec.genotypes:
            continue
        gt = rec.genotypes[0]
        total += 1
        is_hom = len(set(gt)) == 1 and gt[0] > 0
        if not is_hom:
            continue
        hom += 1
        if rec.pos < cursor:
            continue  # overlaps an applied variant; bcftools skips these too
        alt = rec.alts[gt[0] - 1]
        parts.append(ref[cursor:rec.pos])
        parts.append(alt)
        cursor = rec.pos + len(rec.ref)
    parts.append(ref[cursor:])
    seq = "".join(parts)
    with open(out_fa, "w") as f:
        f.write(f">{ctg or 'consensus'}\n")
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + "\n")
    return total, hom, total - hom


def run_pangenie(reads_path: str, ref_path: str, vcf_path: str, out_fa: str,
                 threads: int = 4, tmp_dir: str | None = None,
                 log_path: str | None = None) -> CompetitorResult:
    """PanGenie genotyping + native hom-consensus (run_PG.py:41-70).
    Requires `PanGenie` on PATH; the bcftools/bgzip/tabix post-processing
    chain is replaced by hom_consensus()."""
    if shutil.which("PanGenie") is None:
        return CompetitorResult("PanGenie", None, 0.0,
                                skipped="missing tools: PanGenie")
    t0 = time.time()
    own_tmp = tmp_dir is None
    tmp = tmp_dir or tempfile.mkdtemp(prefix="phi_pg_")
    os.makedirs(tmp, exist_ok=True)
    try:
        prefix = f"{tmp}/sample_PG"
        _run(["PanGenie", "-i", reads_path, "-r", ref_path, "-v", vcf_path,
              "-o", prefix, "-t", str(threads)], log_path)
        total, hom, het = hom_consensus(f"{prefix}_genotyping.vcf", ref_path,
                                        out_fa)
        if log_path:
            with open(log_path, "a") as f:
                f.write(f"Total variants: {total}, Homozygous variants: "
                        f"{hom}, Heterozygous variants: {het}\n")
    finally:
        if own_tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    return CompetitorResult("PanGenie", out_fa, time.time() - t0)


def competitor_matrix(tool: str, cells: list[tuple[str, str, str, str]],
                      *, gbz_path: str | None = None,
                      ref_path: str | None = None, vcf_path: str | None = None,
                      threads: int = 4, out_csv: str | None = None,
                      work_dir: str | None = None):
    """Run a competitor over (read_name, coverage, reads_path, truth_path)
    cells — the run_VG.py / run_PG.py matrix — and score with the native
    banded Myers edit distance (the reference appends edlib-aligner output).
    Returns MatrixCell rows in the same data/plots CSV shape as PHI's own
    matrices; cells whose tool chain is unavailable are omitted with a
    warning."""
    import sys

    from phi_tpu_torch.eval.batch import MatrixCell, write_matrix_csv
    from phi_tpu_torch.eval.edits import edit_stats_files
    work = work_dir or tempfile.mkdtemp(prefix="phi_comp_")
    os.makedirs(work, exist_ok=True)
    rows: list[MatrixCell] = []
    for read_name, cov, reads_path, truth_path in cells:
        out_fa = os.path.join(work, f"rec_hap_{read_name}_{cov}_{tool}.fa")
        log = os.path.join(work, f"rec_hap_{read_name}_{cov}_{tool}.log")
        if tool == "VG":
            res = run_vg(gbz_path, reads_path, out_fa, threads, log_path=log)
        elif tool == "PanGenie":
            res = run_pangenie(reads_path, ref_path, vcf_path, out_fa,
                               threads, log_path=log)
        else:
            raise ValueError(f"unknown competitor {tool!r} (VG | PanGenie)")
        if res.skipped:
            print(f"[W::competitors] {tool} {read_name}/{cov} skipped: "
                  f"{res.skipped}", file=sys.stderr)
            continue
        st = edit_stats_files(out_fa, truth_path)
        rows.append(MatrixCell(read_name=read_name, coverage=cov,
                               real_time_s=res.wall_s, peak_rss_gb=0.0,
                               edit_distance=st.edit_distance,
                               recombinations=0))
    if out_csv and rows:
        write_matrix_csv(rows, out_csv)
    return rows
