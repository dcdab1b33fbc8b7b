"""Host-side preparation of the solver's tables: the jax-free counterpart of
`phi_tpu/solve/prep.py`.

Encodes the reference's expanded graph as flat arrays over lane states
(h, p): switch edges exist per graph edge (u, v) from every lane through u
whose next vertex is not v, into every lane through v, at cost R; in-lane
edges are consecutive walk positions (cost 0). In exact mode the device
builds S, B and the straddle layers W from the occurrence columns
(solve.dp.build_sbw). Where spans need more than MAX_LAYERS layers (chains
of empty nodes) the tables carry n_layers None and dense host S and B, and
the solver runs the reference's bracket solve (solve.dp.solve_dp_both).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from phi_tpu_torch.graph.pangenome import PangenomeGraph, ragged_arange
from phi_tpu_torch.anchors.join import (AnchorTables, credit_arrays,
                                        credit_arrays_from_occ)


@dataclasses.dataclass
class SolverTables:
    # dense credit arrays, None in exact mode (the device builds its own);
    # bracket mode carries them (dense())
    S: np.ndarray | None      # float32 [H, P] entry charge (starts < p)
    B: np.ndarray | None      # float32 [H, P] exit reward (ends <= p)
    esrc_h: np.ndarray        # int32 [n_src] lane of diverging source state
    esrc_p: np.ndarray        # int32 [n_src] position of source state
    esrc_target: np.ndarray   # int32 [n_src] target vertex of the graph edge
    esrc_edge: np.ndarray     # int32 [n_src] graph edge id (decode/report)
    state_vertex: np.ndarray  # int32 [H, P] (= walk_mat, -1 pad)
    walk_len: np.ndarray      # int32 [H]
    R: float
    const: float              # sum of occurrence-kmer weights (sum_i mu_i)
    n_vtx: int
    # Exact-credit correction layer count: the straddle stack
    # W[j, h, p] = weight of occurrences with start < p-j <= p < end. With
    # n_layers >= max_span - 1 the per-visit credit is exact, so the DP
    # value is the local-credit relaxation optimum (bound AND search).
    # None: the bracket solve (spans need more than MAX_LAYERS layers).
    n_layers: int | None
    # host occurrence columns (weighted): decode's lazy straddle queries
    occ_hap: np.ndarray | None = None     # int32 [n_occ]
    occ_start: np.ndarray | None = None   # int32 [n_occ]
    occ_end: np.ndarray | None = None     # int32 [n_occ]
    occ_weight: np.ndarray | None = None  # float32 [n_occ]
    # device occurrence columns (anchors.device.DeviceOcc): the solver
    # builds S/B/W from these, uploading only fresh weights
    occ_dev: object | None = None

    @property
    def H(self) -> int:
        return self.state_vertex.shape[0]

    @property
    def P(self) -> int:
        return self.state_vertex.shape[1]

    def dense(self) -> "SolverTables":
        """The tables with dense host S and B (self if they have them)."""
        if self.S is not None:
            return self
        S, B = credit_arrays_from_occ(self.occ_hap, self.occ_start,
                                      self.occ_end, self.occ_weight,
                                      self.H, self.P)
        return dataclasses.replace(self, S=S, B=B)

    def S_row(self, h: int) -> np.ndarray:
        """One lane's dense S row (entry charge, starts < p)."""
        if self.S is not None:
            return self.S[h]
        cache = getattr(self, "_s_rows", None)
        if cache is None:
            cache = {}
            self._s_rows = cache
        row = cache.get(h)
        if row is None:
            P = self.P
            m = self.occ_hap == h
            start_next = self.occ_start[m].astype(np.int64) + 1
            keep = start_next < P
            diff = np.bincount(start_next[keep],
                               weights=self.occ_weight[m][keep], minlength=P)
            row = np.cumsum(diff[:P], dtype=np.float64).astype(np.float32)
            cache[h] = row
        return row


def switch_sources(graph: PangenomeGraph):
    """(esrc_h, esrc_p, esrc_target, esrc_edge): one row per (edge,
    diverging source lane). Lanes whose next vertex is the edge target take
    the free in-lane edge instead."""
    H, P = graph.walk_mat.shape
    lov = graph.lanes_of_vertex
    u_e, v_e = graph.edge_u, graph.edge_v
    # a lane through u diverges from (u, v) iff its next vertex != v; at an
    # out-degree-1 vertex with no lane ending there, no lane does
    odeg = np.bincount(u_e, minlength=graph.n_vtx)
    has_end = np.zeros(graph.n_vtx, bool)
    ends = graph.walk_mat[np.arange(H), np.maximum(graph.walk_len - 1, 0)]
    has_end[ends[graph.walk_len > 0]] = True
    active = np.flatnonzero((odeg[u_e] > 1) | has_end[u_e]).astype(np.int32)
    u_a, v_a = u_e[active], v_e[active]
    counts = (lov.off[u_a + 1] - lov.off[u_a]).astype(np.int32)
    rep = np.repeat(np.arange(len(u_a), dtype=np.int32), counts)
    idx = np.repeat(lov.off[u_a].astype(np.int32), counts) \
        + ragged_arange(counts, np.int32)
    flat = lov.values[idx]
    sh, sp = np.divmod(flat, P)
    sh = sh.astype(np.int32, copy=False)
    sp = sp.astype(np.int32, copy=False)
    # next vertex in lane, or -1 at the lane end (lane ends always diverge)
    next_vtx = np.full((H, P), -1, dtype=np.int32)
    next_vtx[:, :-1] = graph.walk_mat[:, 1:]
    diverge = next_vtx[sh, sp] != v_a[rep]
    return (sh[diverge], sp[diverge],
            v_a[rep[diverge]].astype(np.int32),
            active[rep[diverge]].astype(np.int32))


def switch_sources_cached(graph: PangenomeGraph):
    """switch_sources, cached on the graph (it depends only on the graph;
    Lagrangian rounds and B&B nodes reuse it)."""
    cached = getattr(graph, "_esrc_cache", None)
    if cached is None:
        cached = switch_sources(graph)
        graph._esrc_cache = cached
    return cached


def _bucket_layers(n: int) -> int:
    """Layer counts rounded up to {0, 1, 2, 4, 8, ...}; extra layers are
    inert (W_j == 0 for j >= max_span - 1)."""
    if n <= 0:
        return 0
    b = 1
    while b < n:
        b *= 2
    return b


# Above this many correction layers the tables take bracket mode (the W
# stack would be L * H * P floats); spans this long only arise from chains
# of zero-length nodes.
MAX_LAYERS = 64


def max_kmer_span(graph: PangenomeGraph, k: int) -> int:
    """Upper bound on occ_end - occ_start for any k-mer anchor (the worst
    case starts at the last base of a node)."""
    cache = getattr(graph, "_span_cache", None)
    if cache is None:
        cache = {}
        graph._span_cache = cache
    if k in cache:
        return cache[k]
    m = 1
    for h in range(graph.num_walks):
        cl = graph.walk_node_cumlen[h]
        n = len(cl) - 1
        if n <= 0:
            continue
        last_base = cl[1:] - 1
        e_idx = np.searchsorted(cl, last_base + k - 1, side="right") - 1
        e_idx = np.minimum(e_idx, n - 1)
        m = max(m, int((e_idx - np.arange(n)).max()))
    cache[k] = m
    return m


def solver_layers(graph: PangenomeGraph, k: int) -> int:
    return _bucket_layers(max_kmer_span(graph, k) - 1)


def build_solver_tables(graph: PangenomeGraph, anchors: AnchorTables,
                        R: float, n_layers: int | None = None,
                        const_override: float | None = None) -> SolverTables:
    """n_layers: W-layer count (default: from the anchors present); above
    MAX_LAYERS the tables take bracket mode (n_layers None, dense S and B,
    which device anchors get from dense() once materialized).
    const_override: explicit sum_i mu_i (branch-and-bound zeroes single
    occurrence weights, which must not change the per-k-mer constant)."""
    esrc_h, esrc_p, esrc_target, esrc_edge = switch_sources_cached(graph)
    dev = anchors.device_occ
    S = B = None
    if anchors.occ_kmer is None:
        # device anchors before materialize, weights all 1.0: the constant
        # is the number of model k-mers
        const = float(anchors.n_model_kmers)
        if n_layers is None:
            n_layers = _bucket_layers(dev.max_span - 1)
        if n_layers > MAX_LAYERS:
            n_layers = None
    else:
        if const_override is not None:
            const = float(const_override)
        elif len(anchors.occ_kmer):
            # first-occurrence index of each k-mer, cached on the graph:
            # refinement rounds share occ_kmer by identity
            cache = getattr(graph, "_first_occ", None)
            if cache is None or cache[0] is not anchors.occ_kmer:
                _, first = np.unique(anchors.occ_kmer, return_index=True)
                cache = (anchors.occ_kmer, first)
                graph._first_occ = cache
            const = float(anchors.occ_weight[cache[1]].sum())
        else:
            const = 0.0
        if n_layers is None:
            max_span = int((anchors.occ_end - anchors.occ_start).max()) \
                if len(anchors.occ_hap) else 1
            n_layers = _bucket_layers(max_span - 1)
        if n_layers > MAX_LAYERS:
            n_layers = None
            S, B = credit_arrays(graph, anchors)
    return SolverTables(
        S=S, B=B, esrc_h=esrc_h, esrc_p=esrc_p, esrc_target=esrc_target,
        esrc_edge=esrc_edge, state_vertex=graph.walk_mat,
        walk_len=graph.walk_len, R=float(R), const=const, n_vtx=graph.n_vtx,
        n_layers=n_layers, occ_hap=anchors.occ_hap,
        occ_start=anchors.occ_start, occ_end=anchors.occ_end,
        occ_weight=anchors.occ_weight, occ_dev=dev)
