"""GFA v1.1 data, reading and writing: the port's copy of
`phi_tpu/io/gfa.py`.

`GfaData` holds segment sequences in one concatenated code buffer with
offsets, the forward-strand edge list and the W-line walks as vertex-id
arrays. `read_gfa` runs the native parser (the reference's orientation
folding and majority-strand walk normalization are in
`native/phi_native.cpp`); `write_gfa` writes the same text as the JAX
package's writer, so synthetic instances are byte-identical.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

# Base codes: A=0 C=1 G=2 T=3, everything else 4 ("invalid").
# Numeric order of the 2-bit codes equals ASCII lexicographic order of ACGT,
# which is what makes numeric minimizer comparison match the reference's
# string comparison (ILP_index.cpp:394). See DESIGN.md.
BASE_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    BASE_LUT[_b] = _i
    BASE_LUT[_b + 32] = _i  # lowercase

CODE2BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode_seq(seq: bytes | str) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode()
    return BASE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode_seq(codes: np.ndarray) -> str:
    return CODE2BASE[codes].tobytes().decode()


@dataclasses.dataclass
class GfaData:
    """Raw parse result, before tensorization into a PangenomeGraph."""

    seg_names: list[str]
    node_len: np.ndarray        # int64 [n_vtx]
    node_off: np.ndarray        # int64 [n_vtx + 1], offsets into seq_code
    seq_code: np.ndarray        # uint8 [total_len], 0..4
    edge_u: np.ndarray          # int32 [n_edges]  (forward-strand, deduped)
    edge_v: np.ndarray          # int32 [n_edges]
    walks: list[np.ndarray]     # per walk: int32 vertex ids
    walk_names: list[str]       # "sample.hap" (ILP_index.cpp:98)
    # GFA fidelity extras (round-tripped by write_gfa):
    seg_tags: list[str] | None = None
    #   per segment: raw tab-joined typed tag suffix of its S line, e.g.
    #   "LN:i:30\tSN:Z:chr6" ("" if none) — gfa_aux_parse analog keeps the
    #   bytes, parse_tags() below gives typed access (gfa-io.cpp:117-177)
    walk_meta: list[tuple[str, int, int]] | None = None
    #   per walk: (seq_name, seq_start, seq_end) from W columns 4-6
    #   (gfa-io.cpp:379-389); writer emits them back (not "_ 0 len")

    @property
    def n_vtx(self) -> int:
        return len(self.node_len)

    def node_seq_codes(self, v: int) -> np.ndarray:
        return self.seq_code[self.node_off[v]:self.node_off[v + 1]]

    def node_seq(self, v: int) -> str:
        return decode_seq(self.node_seq_codes(v))


def read_gfa(path: str) -> GfaData:
    """Parse a GFA file with the native C++ parser (the JAX package's
    pure-Python parser is its behavioral reference; the port needs the
    native library, so it has no fallback)."""
    from phi_tpu_torch.native import _NO_LIB, parse_gfa_native
    g = parse_gfa_native(path)
    if g is None:
        raise RuntimeError(_NO_LIB)
    return g


def write_gfa(g: GfaData, fh: Iterable | None = None, path: str | None = None) -> str:
    """GFA writer (gfa_print analog, gfa-io.cpp:510-566). Returns the text.
    Round-trips typed S-line tags and W-line seq_name/start/end."""
    lines = ["H\tVN:Z:1.1"]
    for i, name in enumerate(g.seg_names):
        tags = g.seg_tags[i] if g.seg_tags else ""
        suffix = ("\t" + tags) if tags else ""
        lines.append(f"S\t{name}\t{g.node_seq(i)}{suffix}")
    for u, v in zip(g.edge_u.tolist(), g.edge_v.tolist()):
        lines.append(f"L\t{g.seg_names[u]}\t+\t{g.seg_names[v]}\t+\t0M")
    for i, (name, w) in enumerate(zip(g.walk_names, g.walks)):
        sample, hap = name.rsplit(".", 1)
        if g.walk_meta:
            seq_name, st, en = g.walk_meta[i]
        else:
            seq_name, st, en = "_", 0, int(g.node_len[w].sum())
        walk_str = "".join(">" + g.seg_names[v] for v in w.tolist())
        lines.append(f"W\t{sample}\t{hap}\t{seq_name}\t{st}\t{en}\t{walk_str}")
    text = "\n".join(lines) + "\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text
