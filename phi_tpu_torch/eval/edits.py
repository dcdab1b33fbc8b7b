"""Accuracy evaluation: edit distance of an inferred haplotype vs truth (the
port's copy of `phi_tpu/eval/edits.py`'s `edit_stats`).

Replaces the reference's edlib-aligner shellouts (data/edlib_edits.py:26-42,
get_edit_stats.sh) with the native banded Myers implementation. The identity
reported is NW-style: 1 - dist / max(len_a, len_b) (edlib derives identity
from the CIGAR; for near-identical sequences the two agree to ~1e-6).
"""

from __future__ import annotations

import dataclasses

from phi_tpu_torch import native
from phi_tpu_torch.io.gfa import encode_seq


@dataclasses.dataclass
class EditStats:
    edit_distance: int
    identity: float
    len_query: int
    len_target: int


def edit_stats(query: str, target: str) -> EditStats:
    d = native.edit_distance(encode_seq(query), encode_seq(target))
    m = max(len(query), len(target), 1)
    return EditStats(edit_distance=d, identity=1.0 - d / m,
                     len_query=len(query), len_target=len(target))
