"""FASTA/FASTQ (optionally gzip) reads: the port's copy of
`phi_tpu/io/reads.py`'s native loader. Reads come back as one ragged
concatenation of base codes with offsets, which the native read-spectrum
scan takes as it is. The JAX package's pure-Python reader and its padded
2-D batch (for its device read sketch) are not copied: the port needs the
native library and has no device read sketch yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ReadBatch:
    """Reads as a ragged concatenation: read i is concat[off[i]:off[i+1]]
    (concat and off are None when there are no reads)."""

    lengths: np.ndarray  # int32 [n_reads]
    names: list[str]
    concat: np.ndarray | None = None  # uint8 [total_bases]
    off: np.ndarray | None = None     # int64 [n_reads + 1]

    @property
    def n_reads(self) -> int:
        return len(self.lengths)

    @property
    def total_bases(self) -> int:
        return int(self.lengths.sum())


def load_read_batch(path: str) -> ReadBatch:
    """Load a FASTA/FASTQ file (plain or gzipped) with the native parser;
    raises if the library is missing or the file is malformed."""
    from phi_tpu_torch.native import _NO_LIB, load_reads_native
    res = load_reads_native(path)
    if res is None:
        raise RuntimeError(_NO_LIB)
    codes_concat, off, names = res
    if not names:
        return ReadBatch(np.zeros(0, np.int32), [])
    return ReadBatch(np.diff(off).astype(np.int32), names,
                     concat=np.ascontiguousarray(codes_concat, np.uint8),
                     off=off.astype(np.int64))
