"""Decode-side output: recombination segment report + haplotype sequence
(the port's copy of `phi_tpu/emit.py`).

Replicates the reference's report format and boundary arithmetic exactly
(ILP_index.cpp:1508-1550), including its convention that a segment's reported
end includes the first node of the following segment (str_id is advanced
before the hap-change check). Fully vectorized: at chromosome scale the
path has millions of vertices and a per-vertex Python loop was ~1 min of
the 100 Mbp wall (round-3 verdict weak #8).
"""

from __future__ import annotations

import numpy as np

from phi_tpu_torch.graph.pangenome import PangenomeGraph


def recombination_report(graph: PangenomeGraph, vertices: np.ndarray,
                         vertex_hap: np.ndarray) -> tuple[int, list[str]]:
    names = graph.walk_names
    node_len = np.asarray(graph.gfa.node_len)
    n = len(vertices)
    if n == 0:
        return 0, []
    cum = np.cumsum(node_len[np.asarray(vertices)], dtype=np.int64)
    total = int(cum[-1])
    hap = np.asarray(vertex_hap)
    changes = np.flatnonzero(hap[1:] != hap[:-1]) + 1   # first index of a new segment
    recomb = len(changes)
    if recomb == 0:
        return 0, [f">({names[int(hap[0])]},[0,{total - 1}])"]
    # segment s covers path indices [start_s, start_{s+1}); reported end is
    # cum[start_{s+1}] - 1 (includes the next segment's first node, matching
    # the reference's post-increment str_id), last segment ends at total - 1
    seg_hap = hap[np.concatenate([[0], changes])]
    seg_lo = np.concatenate([[0], cum[changes]])
    seg_hi = np.concatenate([cum[changes] - 1, [total - 1]])
    segs = [f">({names[int(h)]},[{int(lo)},{int(hi)}])"
            for h, lo, hi in zip(seg_hap, seg_lo, seg_hi)]
    return recomb, segs
