"""The benchmark's data: a synthetic 49-haplotype panel and the samples read
from mosaics of it. A frozen, vectorised copy of the port's
`eval/synth.py` recipe (backbone chopped to <= 30 bp nodes, biallelic
sites at a given density, a share of them indels, per-site allele
frequency uniform in [0.1, 0.9]), so that the yardstick does not move when
the program's generator does.

The panel is a deployment's fixed data: it is drawn from the
configuration's own seed, written once per checkout under
`phibench/_cache/<config>/` (the GFA the program reads, and the node codes
and walks the reference and the sample generator read), and reused by
every later run there. Samples are drawn from `--seed`: sample i of a run
comes from the generator seeded with (seed, stream, i), so the same seed
gives the same samples, and no two samples of a run are alike.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
ACGTN = np.frombuffer(b"ACGTN", dtype=np.uint8)
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cache")


class Panel:
    """The panel as the reference and the sample generator read it:
    node base codes (0..3) in one buffer with offsets, and each walk as an
    array of node indices."""

    def __init__(self, node_codes, node_off, walks):
        self.node_codes = node_codes    # uint8 [total]
        self.node_off = node_off        # int64 [n_nodes + 1]
        self.walks = walks              # list of int32 [len]

    @property
    def node_len(self) -> np.ndarray:
        return np.diff(self.node_off)

    @property
    def n_walks(self) -> int:
        return len(self.walks)

    def walk_names(self) -> list[str]:
        return [f"hap{h}.0" for h in range(self.n_walks)]

    def walk_codes(self, h: int) -> np.ndarray:
        """The base codes of walk h."""
        return gather_nodes(self.node_codes, self.node_off, self.walks[h])


def ragged_index(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenation of arange(s, s + n) for each (s, n)."""
    lens = lens.astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    first = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=first[1:])
    return (np.arange(total, dtype=np.int64) - np.repeat(first, lens)
            + np.repeat(starts.astype(np.int64), lens))


def gather_nodes(buf: np.ndarray, off: np.ndarray, nodes: np.ndarray
                 ) -> np.ndarray:
    nodes = np.asarray(nodes, np.int64)
    return buf[ragged_index(off[nodes], off[nodes + 1] - off[nodes])]


def make_panel(seed: int, length: int, n_haps: int, var_rate: float,
               indel_fraction: float, max_node_len: int) -> Panel:
    """The synthetic panel: a random backbone of `length` bases with
    biallelic sites at `var_rate`, a share `indel_fraction` of them
    insertions (1-5 bases after the reference base) or deletions (of the
    reference base), the rest substitutions. Nodes, in file order: the
    chunks between sites chopped to `max_node_len`, then each site's
    reference node and its alternative node (none for a deletion)."""
    rng = np.random.default_rng([seed, 0x5EED])
    n_sites = max(1, int(length * var_rate))
    pos = np.sort(rng.choice(np.arange(1, length - 1), n_sites,
                             replace=False))
    ref = rng.integers(0, 4, length, dtype=np.uint8)
    is_indel = rng.random(n_sites) < indel_fraction
    is_ins = is_indel & (rng.random(n_sites) < 0.5)
    is_del = is_indel & ~is_ins
    ins_len = np.where(is_ins, rng.integers(1, 6, n_sites), 0)
    snp = (ref[pos] + rng.integers(1, 4, n_sites)).astype(np.uint8) % 4
    freq = rng.uniform(0.1, 0.9, n_sites)
    takes_alt = rng.random((n_sites, n_haps)) < freq[:, None]

    # alternative alleles in one buffer: a substitution's base, an
    # insertion's reference base then its inserted bases, nothing for a
    # deletion
    alt_len = np.where(is_del, 0, np.where(is_ins, 1 + ins_len, 1))
    alt_off = np.zeros(n_sites + 1, np.int64)
    np.cumsum(alt_len, out=alt_off[1:])
    alt_buf = rng.integers(0, 4, int(alt_off[-1]), dtype=np.uint8)
    alt_buf[alt_off[:-1][~is_del]] = np.where(is_ins, ref[pos], snp)[~is_del]

    # chunks between sites and after the last, chopped
    c_start = np.concatenate([[0], pos + 1])
    c_end = np.concatenate([pos, [length]])
    c_len = c_end - c_start
    n_chop = -(-c_len // max_node_len)
    # per chunk j: its chop nodes, then (j < n_sites) site j's ref and alt
    per_group = n_chop + np.concatenate([1 + (~is_del).astype(np.int64),
                                         [0]])
    g_first = np.zeros(len(per_group) + 1, np.int64)
    np.cumsum(per_group, out=g_first[1:])
    n_nodes = int(g_first[-1])
    # every node's source (0: backbone, 1: alt buffer), start and length
    src = np.zeros(n_nodes, np.int8)
    start = np.zeros(n_nodes, np.int64)
    nlen = np.zeros(n_nodes, np.int64)
    kind = np.zeros(n_nodes, np.int8)     # 0 chunk, 1 ref allele, 2 alt
    site = np.full(n_nodes, -1, np.int64)
    chop_idx = ragged_index(g_first[:-1], n_chop)
    chunk_of = np.repeat(np.arange(len(c_len)), n_chop)
    j_in = ragged_index(np.zeros(len(c_len), np.int64), n_chop)
    start[chop_idx] = c_start[chunk_of] + j_in * max_node_len
    nlen[chop_idx] = np.minimum(max_node_len,
                                c_end[chunk_of] - start[chop_idx])
    ref_idx = g_first[:-1][:n_sites] + n_chop[:n_sites]
    start[ref_idx] = pos
    nlen[ref_idx] = 1
    kind[ref_idx] = 1
    site[ref_idx] = np.arange(n_sites)
    has_alt = ~is_del
    alt_idx = ref_idx[has_alt] + 1
    src[alt_idx] = 1
    start[alt_idx] = alt_off[:-1][has_alt]
    nlen[alt_idx] = alt_len[has_alt]
    kind[alt_idx] = 2
    site[alt_idx] = np.flatnonzero(has_alt)

    node_off = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(nlen, out=node_off[1:])
    both = np.concatenate([ref, alt_buf])
    base = np.where(src == 1, length, 0) + start
    node_codes = both[ragged_index(base, nlen)]

    walks = []
    chunk_nodes = kind == 0
    for h in range(n_haps):
        alt_h = takes_alt[:, h]
        keep = chunk_nodes.copy()
        sref = kind == 1
        keep[sref] = ~alt_h[site[sref]]
        salt = kind == 2
        keep[salt] = alt_h[site[salt]]
        walks.append(np.flatnonzero(keep).astype(np.int32))
    return Panel(node_codes, node_off, walks)


def panel_edges(panel: Panel) -> np.ndarray:
    """The graph's edges, int64 [E, 2] sorted: every consecutive pair of
    nodes of some walk."""
    n = len(panel.node_off) - 1
    code = np.unique(np.concatenate([w[:-1].astype(np.int64) * n + w[1:]
                                     for w in panel.walks if len(w) > 1]))
    return np.stack([code // n, code % n], 1)


def write_gfa(panel: Panel, path: str) -> None:
    """GFA v1.1: S lines (names 1..N in node order), L lines of the
    edges, one W line a walk (sample hap<h>, haplotype 0)."""
    n = len(panel.node_off) - 1
    names = [str(i + 1).encode() for i in range(n)]
    seq = ACGT[panel.node_codes].tobytes()
    off = panel.node_off.tolist()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(b"H\tVN:Z:1.1\n")
        f.write(b"".join(b"S\t" + names[i] + b"\t" + seq[off[i]:off[i + 1]]
                         + b"\n" for i in range(n)))
        e = panel_edges(panel).tolist()
        f.write(b"".join(b"L\t" + names[u] + b"\t+\t" + names[v]
                         + b"\t+\t0M\n" for u, v in e))
        # ">name" tokens of every node in one buffer, gathered per walk
        tok = b"".join(b">" + nm for nm in names)
        tok_arr = np.frombuffer(tok, np.uint8)
        tok_off = np.zeros(n + 1, np.int64)
        np.cumsum([len(nm) + 1 for nm in names], out=tok_off[1:])
        node_len = panel.node_len
        for h, w in enumerate(panel.walks):
            body = gather_nodes(tok_arr, tok_off, w).tobytes()
            total = int(node_len[w].sum())
            f.write(f"W\thap{h}\t0\tchr\t0\t{total}\t".encode() + body
                    + b"\n")
    os.replace(tmp, path)


def load_panel(config: dict, cache_root: str = CACHE) -> tuple[Panel, str]:
    """The configuration's panel and the path of its GFA, made on the first
    call in this checkout and read from the cache after that."""
    p = config["panel"]
    d = os.path.join(cache_root, config["name"])
    gfa = os.path.join(d, "panel.gfa")
    npz = os.path.join(d, "panel.npz")
    stamp = os.path.join(d, "panel.json")
    if os.path.exists(stamp):
        with open(stamp) as f:
            if json.load(f) == p:
                z = np.load(npz)
                woff = z["walk_off"]
                flat = z["walks"]
                walks = [flat[woff[i]:woff[i + 1]]
                         for i in range(len(woff) - 1)]
                return Panel(z["node_codes"], z["node_off"], walks), gfa
    os.makedirs(d, exist_ok=True)
    panel = make_panel(p["seed"], p["length"], p["haplotypes"],
                       p["var_rate"], p["indel_fraction"], p["max_node_len"])
    write_gfa(panel, gfa)
    woff = np.zeros(panel.n_walks + 1, np.int64)
    np.cumsum([len(w) for w in panel.walks], out=woff[1:])
    np.savez(npz, node_codes=panel.node_codes, node_off=panel.node_off,
             walks=np.concatenate(panel.walks), walk_off=woff)
    with open(stamp, "w") as f:
        json.dump(p, f)
    return panel, gfa


# ------------------------------------------------------------- samples

class Sample:
    """One sample: its reads as a [n, read_len] code matrix (4 an N), and
    the mosaic it was read from (for the record only)."""

    def __init__(self, reads: np.ndarray, breaks: list[tuple[int, int]]):
        self.reads = reads
        self.breaks = breaks


def make_sample(panel: Panel, seed: int, stream: int, index: int,
                traffic: dict) -> Sample:
    """Sample `index` of stream `stream`, drawn as a held-out target: a
    mosaic of the panel's walks with switchpoints drawn from
    traffic["switches"] = [lo, hi], carrying private substitutions at
    traffic["private_rate"] a base, so it is no walk of the panel; read at
    traffic["coverage"] as reads of traffic["read_len"] bases with
    substitution errors at traffic["error_rate"], N at traffic["n_rate"],
    and a share traffic["reverse_share"] of the reads taken from the
    reverse strand."""
    rng = np.random.default_rng([seed, stream, index])
    H = panel.n_walks
    lo, hi = traffic["switches"]
    n_sw = int(rng.integers(lo, hi + 1))
    haps = [int(rng.integers(0, H))]
    for _ in range(n_sw):
        nxt = int(rng.integers(0, H - 1))
        haps.append(nxt + (nxt >= haps[-1]))
    codes = [panel.walk_codes(h) for h in sorted(set(haps))]
    by_hap = dict(zip(sorted(set(haps)), codes))
    length = min(len(c) for c in codes)
    cuts = np.sort(rng.choice(np.arange(1, length), n_sw, replace=False))
    edges = [0] + cuts.tolist()
    parts = [by_hap[h][a:b] for h, a, b in
             zip(haps, edges, edges[1:] + [len(by_hap[haps[-1]])])]
    target = np.concatenate(parts)
    _substitute(rng, target, traffic["private_rate"])
    rl = int(traffic["read_len"])
    n_reads = max(1, int(traffic["coverage"] * len(target) / rl))
    starts = rng.integers(0, len(target) - rl + 1, n_reads)
    reads = target[starts[:, None] + np.arange(rl)]
    _substitute(rng, reads, traffic["error_rate"])
    reads[rng.random(reads.shape) < traffic["n_rate"]] = 4
    rev = rng.random(n_reads) < traffic["reverse_share"]
    flipped = reads[rev, ::-1]
    reads[rev] = np.where(flipped == 4, 4, 3 - flipped)
    return Sample(reads, list(zip(cuts.tolist(), haps[1:])))


def _substitute(rng, codes: np.ndarray, rate: float) -> None:
    """Each base, at `rate`, replaced by one of the other three."""
    hit = rng.random(codes.shape) < rate
    n = int(hit.sum())
    if n:
        codes[hit] = (codes[hit] + rng.integers(1, 4, n, dtype=np.uint8)) % 4


def write_fastq(reads: np.ndarray, path: str, level: int = 1) -> None:
    """Reads as gzip FASTQ: @r<index>, the bases (code 4 an N), +,
    quality I."""
    n, rl = reads.shape
    width = len(str(max(n - 1, 0)))
    head = np.frombuffer("".join(f"@r{i:0{width}d}\n" for i in range(n))
                         .encode(), np.uint8).reshape(n, width + 3)
    rec = np.empty((n, width + 3 + rl + 3 + rl + 1), np.uint8)
    rec[:, :width + 3] = head
    c = width + 3
    rec[:, c:c + rl] = ACGTN[reads]
    rec[:, c + rl:c + rl + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, c + rl + 3:c + 2 * rl + 3] = ord("I")
    rec[:, -1] = ord("\n")
    comp = zlib.compressobj(level, zlib.DEFLATED, 31)
    with open(path, "wb") as f:
        f.write(comp.compress(rec.tobytes()))
        f.write(comp.flush())
