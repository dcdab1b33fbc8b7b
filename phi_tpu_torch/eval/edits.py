"""Accuracy evaluation: edit distance of an inferred haplotype vs truth (the
port's copy of `phi_tpu/eval/edits.py`).

Replaces the reference's edlib-aligner shellouts (data/edlib_edits.py:26-42,
get_edit_stats.sh) with the native banded Myers implementation. The identity
reported is NW-style: 1 - dist / max(len_a, len_b) (edlib derives identity
from the CIGAR; for near-identical sequences the two agree to ~1e-6).
"""

from __future__ import annotations

import dataclasses
import gzip

from phi_tpu_torch import native
from phi_tpu_torch.io.gfa import encode_seq


@dataclasses.dataclass
class EditStats:
    edit_distance: int
    identity: float
    len_query: int
    len_target: int


def _read_fasta_first_seq(path: str) -> str:
    op = gzip.open if path.endswith(".gz") else open
    parts: list[str] = []
    with op(path, "rt") as f:  # type: ignore[arg-type]
        seen = 0
        for line in f:
            if line.startswith(">"):
                seen += 1
                if seen > 1:
                    break
                continue
            parts.append(line.strip())
    return "".join(parts)


def edit_stats(query: str, target: str) -> EditStats:
    d = native.edit_distance(encode_seq(query), encode_seq(target))
    m = max(len(query), len(target), 1)
    return EditStats(edit_distance=d, identity=1.0 - d / m,
                     len_query=len(query), len_target=len(target))


def edit_stats_files(query_fa: str, target_fa: str) -> EditStats:
    return edit_stats(_read_fasta_first_seq(query_fa),
                      _read_fasta_first_seq(target_fa))


def truth_vs_panel(truth_fa: str, panel_fas: list[str]):
    """Edit distance of a truth haplotype against each panel haplotype with
    mean/min/max — the reference's get_edit_stats.sh analysis in-process."""
    truth = _read_fasta_first_seq(truth_fa)
    dists = [edit_stats(truth, _read_fasta_first_seq(p)).edit_distance
             for p in panel_fas]
    if not dists:
        return {"distances": [], "mean": 0.0, "min": 0, "max": 0}
    return {"distances": dists, "mean": sum(dists) / len(dists),
            "min": min(dists), "max": max(dists)}
