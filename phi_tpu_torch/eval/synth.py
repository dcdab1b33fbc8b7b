"""Synthetic pangenome + read generation for scale benchmarking (the port's
copy of `phi_tpu/eval/synth.py`: the same draws from the same generator).

The reference's published scaling axis is haplotype count on a ~5 Mbp MHC
graph (3/7/13/25/49 haps, BASELINE.md). The real 49-hap graph is built by a
cactus pipeline we can't run here, so this generates a structurally similar
instance: a reference backbone chopped to <=30 bp nodes with biallelic
variant bubbles at a given density, per-hap allele assignments, and reads
sampled from a (optionally recombined) target haplotype with errors.
"""

from __future__ import annotations

import numpy as np

from phi_tpu_torch.io.build import build_gfa_data
from phi_tpu_torch.io.gfa import GfaData

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _rand_seq(rng: np.random.Generator, n: int) -> str:
    return _BASES[rng.integers(0, 4, n)].tobytes().decode()


def synth_pangenome(rng: np.random.Generator, length: int = 100_000,
                    n_haps: int = 8, var_rate: float = 0.01,
                    max_node_len: int = 30,
                    indel_fraction: float = 0.0) -> tuple[GfaData, list[str]]:
    """Returns (graph, per-hap sequences). Variants are biallelic at
    ~var_rate density with a random allele frequency per site; a fraction of
    sites are short insertions/deletions (alt allele of different length)."""
    n_sites = max(1, int(length * var_rate))
    positions = np.sort(rng.choice(np.arange(1, length - 1), n_sites,
                                   replace=False))
    segments: dict[str, str] = {}
    counter = 0

    def add(seq: str) -> list[str]:
        nonlocal counter
        out = []
        for i in range(0, len(seq), max_node_len):
            counter += 1
            name = str(counter)  # numeric names, like vg/gfa2gbwt chopped output
            segments[name] = seq[i:i + max_node_len]
            out.append(name)
        return out

    ref = _rand_seq(rng, length)
    walk_segs: list[list[str]] = [[] for _ in range(n_haps)]
    hap_parts: list[list[str]] = [[] for _ in range(n_haps)]
    cursor = 0
    for pos in positions.tolist():
        if pos > cursor:
            shared = add(ref[cursor:pos])
            chunk = ref[cursor:pos]
            for h in range(n_haps):
                walk_segs[h].extend(shared)
                hap_parts[h].append(chunk)
        ref_base = ref[pos]
        if rng.random() < indel_fraction:
            if rng.random() < 0.5:  # insertion after the ref base
                alt_base = ref_base + _rand_seq(rng, int(rng.integers(1, 6)))
            else:  # deletion encoded as an empty-ish alt (keep 1 base anchor)
                alt_base = ""
        else:
            alt_base = "ACGT"[(("ACGT".index(ref_base)) + int(rng.integers(1, 4))) % 4]
        nodes = [add(ref_base), add(alt_base)]
        freq = rng.uniform(0.1, 0.9)
        takes_alt = rng.random(n_haps) < freq
        for h in range(n_haps):
            a = 1 if takes_alt[h] else 0
            walk_segs[h].extend(nodes[a])
            hap_parts[h].append(alt_base if a else ref_base)
        cursor = pos + 1
    if cursor < length:
        tail = add(ref[cursor:])
        chunk = ref[cursor:]
        for h in range(n_haps):
            walk_segs[h].extend(tail)
            hap_parts[h].append(chunk)

    walks = [(f"synth{h}.0", walk_segs[h]) for h in range(n_haps)]
    hap_seqs = ["".join(p) for p in hap_parts]
    return build_gfa_data(segments, walks), hap_seqs


def sample_reads(rng: np.random.Generator, hap_seqs: list[str],
                 coverage: float = 1.0, read_len: int = 150,
                 error_rate: float = 0.001,
                 recomb_breaks: list[tuple[int, int]] | None = None,
                 indel_rate: float = 0.0
                 ) -> tuple[list[str], str]:
    """Reads from a (possibly recombined) target. recomb_breaks is a list of
    (position, hap) switch points; default = pure hap 0. error_rate is the
    per-base substitution probability; indel_rate the per-base probability
    of a 1 bp insertion or deletion (50/50) — the error class real
    platforms add on top of substitutions (short reads ~0.01-0.1%, long
    reads ~1-5%; the reference's accuracy runs use real SRA reads,
    data/preprocess.py:64-109). Returns (reads, target_sequence)."""
    length = len(hap_seqs[0])
    if recomb_breaks:
        target = []
        cur_hap = 0
        cursor = 0
        for pos, hap in recomb_breaks:
            target.append(hap_seqs[cur_hap][cursor:pos])
            cur_hap, cursor = hap, pos
        target.append(hap_seqs[cur_hap][cursor:])
        target_seq = "".join(target)
    else:
        target_seq = hap_seqs[0]
    n_reads = max(1, int(coverage * len(target_seq) / read_len))
    # draw a slightly longer template span so deletions still yield
    # read_len emitted bases (trimmed back after editing)
    span = read_len if indel_rate <= 0 else \
        min(len(target_seq), int(read_len * (1 + 4 * indel_rate)) + 8)
    starts = rng.integers(0, max(1, len(target_seq) - span), n_reads)
    reads = []
    for s in starts.tolist():
        arr = np.frombuffer(target_seq[s:s + span].encode(), np.uint8).copy()
        errs = rng.random(len(arr)) < error_rate
        if errs.any():
            arr[errs] = _BASES[rng.integers(0, 4, int(errs.sum()))]
        if indel_rate > 0:
            ind = np.flatnonzero(rng.random(len(arr)) < indel_rate)
            if len(ind):
                parts = []
                cursor = 0
                for p in ind.tolist():
                    parts.append(arr[cursor:p])
                    if rng.random() < 0.5:   # insertion before base p
                        parts.append(_BASES[rng.integers(0, 4, 1)])
                        parts.append(arr[p:p + 1])
                    # else: deletion of base p (emit nothing)
                    cursor = p + 1
                parts.append(arr[cursor:])
                arr = np.concatenate(parts)
        reads.append(arr[:read_len].tobytes().decode())
    return reads, target_seq
