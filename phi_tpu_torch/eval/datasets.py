"""MHC benchmark dataset construction — the reference's data/preprocess.py
pipeline (Zenodo panel archive -> agc extract -> cactus pangenome ->
chopped GFA; SRA read sets -> coverage titrations), rebuilt with the same
step structure. External downloads/tools (wget, agc, cactus-pangenome,
fastq-dump, seqkit) are GATED: each step runs when its tool is on PATH and
reports a clean skip otherwise (a machine without network access). Steps the
reference shelled out to text tools for (header rewrite, mean read length,
count-based sampling) are implemented natively.

Reference: data/preprocess.py:33-109, chop_graph.sh. The synthetic
instance generator (eval/synth.py + eval/scale.py) is the egress-free
substitute used for this repo's measured benchmarks. The port's copy of
`phi_tpu/eval/datasets.py` (host only).

    python -m phi_tpu_torch.eval.datasets [-o data] [-t 4]
"""

from __future__ import annotations

import gzip
import os
import shutil
import subprocess

import numpy as np

PANEL_URL = "https://zenodo.org/records/6617246/files/MHC-61.agc?download=1"
# SRA run ids per sample (preprocess.py:63-69)
SRA_RUNS = {
    "APD": "SRR17272303",
    "DBB": "SRR17272302",
    "MANN": "SRR17272301",
    "QBL": "SRR17272300",
    "SSTO": "SRR17272299",
}
COVERAGES = [0.1, 0.5, 1, 2, 5, 10, 15]  # preprocess.py:85
REGION_LEN = 5_000_000                   # preprocess.py:105 assumption


def _tool(name: str) -> str | None:
    return shutil.which(name)


def rename_chm13_header(fasta_path: str) -> None:
    """'>CHM13#0' -> '>0' (the awk step, preprocess.py:43), in place."""
    op = gzip.open if fasta_path.endswith(".gz") else open
    with op(fasta_path, "rt") as f:
        text = f.read()
    text = text.replace(">CHM13#0\n", ">0\n")
    with op(fasta_path, "wt") as f:
        f.write(text)


def mean_read_length(fastq_path: str) -> float:
    """Native `seqkit stats` column 7 (preprocess.py:95-101)."""
    from phi_tpu_torch.eval.batch import fastq_records
    total = count = 0
    for rec in fastq_records(fastq_path):
        total += len(rec[1].strip())
        count += 1
    return total / max(count, 1)


def sample_n_reads(in_path: str, out_path: str, n: int, seed: int) -> int:
    """Native `seqkit sample -s seed -n N` (preprocess.py:108): reservoir
    sample of N whole FASTQ records, written in input order."""
    from phi_tpu_torch.eval.batch import fastq_open, fastq_records
    rng = np.random.default_rng(seed)
    reservoir: list[tuple[int, list[str]]] = []
    for i, rec in enumerate(fastq_records(in_path)):
        if len(reservoir) < n:
            reservoir.append((i, rec))
        else:
            j = int(rng.integers(0, i + 1))
            if j < n:
                reservoir[j] = (i, rec)
    reservoir.sort(key=lambda t: t[0])
    with fastq_open(out_path, "wt") as out:
        for _, rec in reservoir:
            out.writelines(rec)
    return len(reservoir)


def downsample_by_coverage(reads_dir: str, out_dir: str,
                           samples: list[str] | None = None,
                           coverages: list[float] | None = None,
                           region_len: int = REGION_LEN,
                           seed: int = 17) -> list[str]:
    """The preprocess.py:104-109 titration: per (sample, coverage), keep
    cov*region_len/mean_len reads (all reads at 15x). Fully native."""
    os.makedirs(out_dir, exist_ok=True)
    samples = samples or sorted(SRA_RUNS)
    coverages = coverages or COVERAGES
    produced = []
    for s in samples:
        src = os.path.join(reads_dir, f"{s}.fastq")
        if not os.path.exists(src) and os.path.exists(src + ".gz"):
            src = src + ".gz"
        if not os.path.exists(src):
            continue
        mean_len = mean_read_length(src)
        for cov in coverages:
            n = int(cov * region_len / max(mean_len, 1.0))
            if cov == 15:
                n = 10 ** 9  # all available reads (preprocess.py:107)
            dst = os.path.join(out_dir, f"{s}_{cov:g}x.fastq")
            sample_n_reads(src, dst, n, seed)
            produced.append(dst)
    return produced


def build_mhc_dataset(out_dir: str = "data", threads: int = 4,
                      runner=subprocess.run) -> dict:
    """Run every constructible step; returns a step -> status report.
    Statuses: 'done', 'skipped (<tool> not on PATH)'."""
    report: dict[str, str] = {}
    os.makedirs(out_dir, exist_ok=True)
    haps_dir = os.path.join(out_dir, "hprc_haps")

    # 1. panel archive (wget + agc), preprocess.py:33-41
    if _tool("wget") and _tool("agc"):
        agc = os.path.join(out_dir, "MHC-61.agc")
        runner(["wget", "-q", PANEL_URL, "-O", agc], check=True)
        os.makedirs(haps_dir, exist_ok=True)
        runner(["agc", "getcol", "-o", haps_dir, agc], check=True)
        chm13 = os.path.join(haps_dir, "MHC-CHM13.0.fa")
        if os.path.exists(chm13):
            rename_chm13_header(chm13)  # the awk step, native
        report["panel"] = "done"
    else:
        report["panel"] = "skipped (wget/agc not on PATH)"

    # 2. minigraph-cactus pangenome, preprocess.py:49-52
    if _tool("cactus-pangenome"):
        runner(["cactus-pangenome", "./js", "MHC.seqfile",
                "--outDir", os.path.join(out_dir, "MHC-49_MC_out"),
                "--outName", "MHC-49-MC", "--reference", "CHM13.0", "--vcf",
                "--maxCores", str(threads),
                "--batchSystem", "single_machine"], check=True)
        report["pangenome"] = "done"
    else:
        report["pangenome"] = "skipped (cactus-pangenome not on PATH)"

    # 3. chop + progressive subsets: natively via the VCF converter (<=30
    #    bp chop, vcfio/vcf2graph.py) and the subset tool (io/subset.py) —
    #    no hal2vg/vg needed; chop_graph.sh parity is exercised by
    #    eval/scale.py. The report keeps the reference package's wording.
    report["chop"] = "native (phi-vcf2gfa --chop 30, phi-subset)"

    # 4. SRA reads (wget + fastq-dump), preprocess.py:72-80: download the
    # run blob, split-dump, then merge the split files into {sample}.fastq
    # (the reference's `cat data/reads/{read}_* > data/reads/{read}.fastq`)
    reads_dir = os.path.join(out_dir, "reads")
    if _tool("wget") and _tool("fastq-dump"):
        os.makedirs(reads_dir, exist_ok=True)
        for name, run in SRA_RUNS.items():
            url = f"https://sra-pub-run-odp.s3.amazonaws.com/sra/{run}/{run}"
            blob = os.path.join(out_dir, name + ".sra")
            runner(["wget", "-q", "-O", blob, url], check=True)
            runner(["fastq-dump", "--split-files", "--outdir", reads_dir,
                    blob], check=True)
            parts = sorted(f for f in os.listdir(reads_dir)
                           if f.startswith(os.path.basename(blob).replace(
                               ".sra", "_")) and f.endswith(".fastq"))
            with open(os.path.join(reads_dir, name + ".fastq"), "w") as out:
                for part in parts:
                    pp = os.path.join(reads_dir, part)
                    with open(pp) as f:
                        shutil.copyfileobj(f, out)
                    os.remove(pp)
        report["reads"] = "done"
    else:
        report["reads"] = "skipped (wget/fastq-dump not on PATH)"

    # 5. coverage titrations — native (no seqkit needed)
    if os.path.isdir(reads_dir) and any(
            f.endswith((".fastq", ".fastq.gz")) for f in os.listdir(reads_dir)):
        produced = downsample_by_coverage(
            reads_dir, os.path.join(out_dir, "reads_downsampled"))
        report["downsample"] = f"done ({len(produced)} files)"
    else:
        report["downsample"] = "skipped (no read sets present)"
    return report


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(
        prog="phi-torch-datasets",
        description="reference preprocess.py pipeline (tool-gated)")
    ap.add_argument("-t", "--threads", type=int, default=4)
    ap.add_argument("-o", "--out-dir", default="data")
    args = ap.parse_args(argv)
    report = build_mhc_dataset(args.out_dir, args.threads)
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
