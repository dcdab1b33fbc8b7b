"""Brute-force expanded-graph oracle: the jax-free counterpart of
`phi_tpu/solve/exact.py` (the pipeline's exact small-case escalation).

Enumerates every source-to-sink path of the expanded graph (lane states with
in-lane and diverging-switch transitions, exactly the reference's construction
ILP_index.cpp:1160-1409) and scores each under the exact objective
R * switches + (n_model_kmers - distinct covered k-mers) — the ILP/IQP
optimum for small instances. Exponential; use only on toy graphs.
"""

from __future__ import annotations

import numpy as np

from phi_tpu_torch.anchors.join import AnchorTables
from phi_tpu_torch.graph.pangenome import PangenomeGraph
from phi_tpu_torch.solve.prep import SolverTables


def enumerate_paths(graph: PangenomeGraph, t: SolverTables, max_paths: int = 200000):
    """Yield lists of segments [(h, q, p)] for every expanded-graph path."""
    H, P = t.state_vertex.shape
    walk_len = t.walk_len
    # switch adjacency: from state (h,p) -> list of entry states (h2, q2)
    # via diverging edges: source (h,p) with edge (u,v); entries = lanes of v
    by_src: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for i in range(len(t.esrc_h)):
        src = (int(t.esrc_h[i]), int(t.esrc_p[i]))
        v = int(t.esrc_target[i])
        lov = graph.lanes_of_vertex
        for flat in lov.group(v):
            h2, q2 = int(flat) // P, int(flat) % P
            by_src.setdefault(src, []).append((h2, q2))

    out: list[list[tuple[int, int, int]]] = []

    def rec(segs: list[tuple[int, int, int]], h: int, q: int):
        if len(out) >= max_paths:
            raise RuntimeError("too many paths for brute force")
        # extend the current in-lane run to every possible exit p >= q
        for p in range(q, int(walk_len[h])):
            cur = segs + [(h, q, p)]
            if p == int(walk_len[h]) - 1:
                out.append(cur)
            for (h2, q2) in by_src.get((h, p), []):
                rec(cur, h2, q2)

    for h in range(H):
        if walk_len[h] > 0:
            rec([], h, 0)
    return out


def score_path(t: SolverTables, anchors: AnchorTables,
               segments: list[tuple[int, int, int]]) -> float:
    covered = np.zeros(len(anchors.occ_hap), bool)
    for (sh, sq, sp) in segments:
        covered |= ((anchors.occ_hap == sh) & (anchors.occ_start >= sq)
                    & (anchors.occ_end <= sp))
    distinct = len(np.unique(anchors.occ_kmer[covered]))
    return t.R * (len(segments) - 1) + (anchors.n_model_kmers - distinct)


def brute_force_optimum(graph: PangenomeGraph, t: SolverTables,
                        anchors: AnchorTables) -> tuple[float, list]:
    paths = enumerate_paths(graph, t)
    best, best_path = np.inf, None
    for segs in paths:
        s = score_path(t, anchors, segs)
        if s < best:
            best, best_path = s, segs
    return float(best), best_path
