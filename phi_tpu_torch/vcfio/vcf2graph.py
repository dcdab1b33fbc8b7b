"""VCF + reference FASTA -> pangenome graph (GfaData): the port's copy of
`phi_tpu/vcfio/vcf2graph.py`, on the port's `io.build` and `io.gfa`.

    python -m phi_tpu_torch.vcfio.vcf2graph -v VCF -r REF.fa > out.gfa

A reference backbone chopped into nodes of at most 30 bp (`-m`), one bubble
per variant record with a node per allele, and one walk per haplotype:
REF, then each phased sample haplotype. Explicit sequence alleles only
(SNPs, indels, MNVs, multi-allelic records); overlapping records merge into
one bubble of the haplotypes' realized sequences; symbolic alleles and
breakends are skipped with a warning.
"""

from __future__ import annotations

import gzip
import sys
from typing import IO

from phi_tpu_torch.io.build import build_gfa_data
from phi_tpu_torch.io.gfa import GfaData, write_gfa


def _open(path: str) -> IO[str]:
    if path.endswith(".gz"):
        return gzip.open(path, "rt")  # type: ignore[return-value]
    return open(path)


def read_fasta(path: str) -> dict[str, str]:
    seqs: dict[str, list[str]] = {}
    name = None
    with _open(path) as f:
        for line in f:
            if line.startswith(">"):
                name = line[1:].split()[0]
                seqs[name] = []
            elif name is not None:
                seqs[name].append(line.strip())
    return {k: "".join(v).upper() for k, v in seqs.items()}


class VcfRecord:
    __slots__ = ("pos", "ref", "alts", "genotypes")

    def __init__(self, pos: int, ref: str, alts: list[str],
                 genotypes: list[tuple[int, ...]]):
        self.pos = pos          # 0-based
        self.ref = ref
        self.alts = alts        # allele index 0 = ref, 1.. = alts
        self.genotypes = genotypes  # per sample, tuple of allele indices


def parse_vcf(path: str, contig: str | None = None
              ) -> tuple[str, list[str], list[VcfRecord]]:
    """Returns (contig, sample_names, records sorted by position)."""
    samples: list[str] = []
    records: list[VcfRecord] = []
    seen_contig = contig
    n_skipped = 0
    with _open(path) as f:
        for line in f:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                samples = line.rstrip("\n").split("\t")[9:]
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 8:
                continue
            chrom, pos, _id, ref, alt = fields[0], fields[1], fields[2], fields[3], fields[4]
            if seen_contig is None:
                seen_contig = chrom
            if chrom != seen_contig:
                continue
            alts = alt.split(",")
            if any(a.startswith("<") or "[" in a or "]" in a or a == "*"
                   for a in alts):
                n_skipped += 1
                continue
            gts: list[tuple[int, ...]] = []
            if len(fields) > 9:
                fmt = fields[8].split(":")
                try:
                    gt_i = fmt.index("GT")
                except ValueError:
                    gt_i = -1
                for col in fields[9:]:
                    if gt_i < 0:
                        gts.append((0,))
                        continue
                    gt = col.split(":")[gt_i]
                    alleles = tuple(
                        0 if a in (".", "") else int(a)
                        for a in gt.replace("|", "/").split("/"))
                    gts.append(alleles)
            records.append(VcfRecord(int(pos) - 1, ref.upper(),
                                     [a.upper() for a in alts], gts))
    if n_skipped:
        print(f"[W::vcf2graph] skipped {n_skipped} symbolic/breakend records",
              file=sys.stderr)
    records.sort(key=lambda r: r.pos)
    return seen_contig or "", samples, records


def _chop(seq: str, max_len: int) -> list[str]:
    return [seq[i:i + max_len] for i in range(0, len(seq), max_len)] or []


def vcf_to_graph(vcf_path: str, ref_path: str, contig: str | None = None,
                 max_node_len: int = 30, ref_walk_name: str = "REF") -> GfaData:
    ref_seqs = read_fasta(ref_path)
    vcf_contig, samples, records = parse_vcf(vcf_path, contig)
    if vcf_contig in ref_seqs:
        ref = ref_seqs[vcf_contig]
    elif len(ref_seqs) == 1:
        ref = next(iter(ref_seqs.values()))
    else:
        raise ValueError(f"contig {vcf_contig!r} not found in {ref_path}")

    # haplotype count per sample from the first record's GT arity
    n_haps = {s: 1 for s in samples}
    for r in records:
        for s, gt in zip(samples, r.genotypes):
            n_haps[s] = max(n_haps[s], len(gt))
        break

    segments: dict[str, str] = {}
    counter = [0]

    def add_seg(seq: str) -> list[str]:
        names = []
        for chunk in _chop(seq, max_node_len):
            counter[0] += 1
            name = str(counter[0])
            segments[name] = chunk
            names.append(name)
        return names

    # walks under construction: REF + one per (sample, hap)
    walk_ids: list[tuple[str, int]] = [(ref_walk_name, 0)]
    for s in samples:
        for h in range(n_haps[s]):
            walk_ids.append((s, h))
    walk_segs: dict[tuple[str, int], list[str]] = {wid: [] for wid in walk_ids}

    def walk_allele(wid: tuple[str, int], rec: VcfRecord, n_alleles: int) -> int:
        if wid[0] == ref_walk_name:
            return 0
        s_i = samples.index(wid[0])
        gt = rec.genotypes[s_i] if s_i < len(rec.genotypes) else (0,)
        a = gt[wid[1]] if wid[1] < len(gt) else gt[-1]
        return a if a < n_alleles else 0

    # group records into overlap clusters; a cluster of >= 2 becomes ONE
    # merged bubble whose alleles are the per-haplotype realized sequences
    # (vg construct represents overlaps as nested bubbles, vcf2gfa.py:50 —
    # merged sites are the chop-compatible equivalent and keep every walk's
    # sequence faithful instead of dropping records)
    clusters: list[list[VcfRecord]] = []
    clu_end = -1
    for rec in records:
        actual = ref[rec.pos:rec.pos + len(rec.ref)]
        if actual != rec.ref:
            raise ValueError(
                f"VCF REF allele mismatch at pos {rec.pos + 1}: "
                f"VCF says {rec.ref!r}, reference has {actual!r}")
        if clusters and rec.pos < clu_end:
            clusters[-1].append(rec)
            clu_end = max(clu_end, rec.pos + len(rec.ref))
        else:
            clusters.append([rec])
            clu_end = rec.pos + len(rec.ref)

    n_conflict = 0
    cursor = 0
    for cluster in clusters:
        start = cluster[0].pos
        end = max(r.pos + len(r.ref) for r in cluster)
        if start > cursor:
            shared = add_seg(ref[cursor:start])
            for wid in walk_ids:
                walk_segs[wid].extend(shared)
        if len(cluster) == 1:
            rec = cluster[0]
            # allele nodes: index 0 = ref allele
            allele_nodes: list[list[str]] = [add_seg(rec.ref)]
            for alt in rec.alts:
                allele_nodes.append(add_seg(alt))
            for wid in walk_ids:
                a = walk_allele(wid, rec, len(allele_nodes))
                walk_segs[wid].extend(allele_nodes[a])
        else:
            # merged site: realize each walk's sequence across the cluster
            # (within one haplotype, a record overlapping an already-applied
            # non-ref allele is a genuine conflict — apply earlier-first)
            seqs: dict[tuple[str, int], str] = {}
            for wid in walk_ids:
                parts: list[str] = []
                cur = start
                for rec in cluster:
                    a = walk_allele(wid, rec, len(rec.alts) + 1)
                    if a == 0:
                        continue
                    if rec.pos < cur:
                        n_conflict += 1
                        continue
                    parts.append(ref[cur:rec.pos])
                    parts.append(rec.alts[a - 1])
                    cur = rec.pos + len(rec.ref)
                parts.append(ref[cur:end])
                seqs[wid] = "".join(parts)
            allele_map: dict[str, list[str]] = {}
            for wid in walk_ids:
                s = seqs[wid]
                if s not in allele_map:
                    allele_map[s] = add_seg(s)
                walk_segs[wid].extend(allele_map[s])
        cursor = end
    if n_conflict:
        print(f"[W::vcf2graph] {n_conflict} intra-haplotype overlap "
              "conflicts resolved earlier-record-first", file=sys.stderr)
    if cursor < len(ref):
        tail = add_seg(ref[cursor:])
        for wid in walk_ids:
            walk_segs[wid].extend(tail)

    walks = [(f"{name}.{hap}", walk_segs[(name, hap)])
             for (name, hap) in walk_ids]
    return build_gfa_data(segments, walks)


def main(argv: list[str] | None = None) -> int:
    """CLI parity with the reference's `vcf2gfa.py -v VCF -r REF > out.gfa`."""
    import argparse

    p = argparse.ArgumentParser(prog="phi-torch-vcf2gfa")
    p.add_argument("-v", dest="vcf", required=True)
    p.add_argument("-r", dest="ref", required=True)
    p.add_argument("-c", dest="contig", default=None)
    p.add_argument("-m", dest="max_node_len", type=int, default=30)
    args = p.parse_args(argv)
    g = vcf_to_graph(args.vcf, args.ref, args.contig, args.max_node_len)
    sys.stdout.write(write_gfa(g))
    return 0


if __name__ == "__main__":
    sys.exit(main())
