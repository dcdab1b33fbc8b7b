"""Backtrace of the converged DP and exact re-scoring of the decoded path:
the jax-free counterpart of `phi_tpu/solve/decode.py`.

Recovers the (vertex, lane) path, counts recombinations, verifies that
every consecutive pair is a graph edge, and re-scores the path under the
exact distinct-k-mer objective so the gap to the DP bound is reported. The
solution is read through `sv_at` and `ent` (solve.dp.DeviceSolution): the
[H, P] M plane stays on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from phi_tpu_torch.graph.pangenome import PangenomeGraph, memoized
from phi_tpu_torch.anchors.join import AnchorTables
from phi_tpu_torch.solve.prep import SolverTables
from phi_tpu_torch.trace import spanned

_EPS = 1e-3


@dataclasses.dataclass
class DecodeResult:
    segments: list[tuple[int, int, int]]  # (hap, start_pos, end_pos) in path order
    vertices: np.ndarray                  # int32 full vertex path
    vertex_hap: np.ndarray                # int32 lane label per path vertex
    n_switches: int                       # R-charged switch edges used
    recombination_count: int              # hap-label changes (report metric)
    matched_distinct: int                 # distinct model k-mers covered
    matched_total: float                  # weighted occurrences covered (DP credit)
    dp_objective: float                   # lower bound from the DP
    true_objective: float                 # exact objective of this path
    n_sweeps: int
    solver_device: str = ""               # device of the DP solution decoded


@spanned("decode")
def decode_path(graph: PangenomeGraph, t: SolverTables, anchors: AnchorTables,
                M, ends: np.ndarray, n_sweeps: int,
                dp_objective: float) -> DecodeResult:
    """M: a solution with `ent` (per-vertex entry minima) and `sv_at`
    (switch-source exit values by esrc row)."""
    H, P = t.state_vertex.shape
    walk_len = t.walk_len
    INF = np.float32(np.inf)
    ent = M.ent
    # the switch sources of vertex v are order[tgt_off[v]:tgt_off[v + 1]]
    order, tgt_off = memoized(t.graph_memo, ("esrc_torder",),
                              lambda: _target_order(t, graph.n_vtx))

    # lane arrays (A, running minimum, rightmost argmin, start entry) are
    # built lazily: the backtrace touches n_switches + 1 lanes
    cols1d = np.arange(P)
    lane_cache: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray, float]] = {}

    def lane_arrays(h: int):
        got = lane_cache.get(h)
        if got is None:
            row_valid = cols1d < walk_len[h]
            sv_row = t.state_vertex[h]
            e_row = np.where(sv_row >= 0,
                             ent[np.maximum(sv_row, 0)] + t.R, INF)
            start_entry_h = float(e_row[0])
            e_row[0] = min(e_row[0], np.float32(0.0))
            A_row = np.where(row_valid, e_row + t.S_row(h), INF)
            run_min_row = np.minimum.accumulate(A_row)
            qlatest_row = np.maximum.accumulate(
                np.where(A_row <= run_min_row, cols1d, -1))
            got = (A_row, run_min_row, qlatest_row, start_entry_h)
            lane_cache[h] = got
        return got

    L = t.n_layers or 0   # bracket mode: no straddle layers
    if L > 0:
        # lazy straddle queries: occurrences per lane sorted by start (the
        # sort depends only on the layout, shared across refinement rounds)
        o_order = memoized(t.sample_memo, ("occ_sorder",), lambda: np.argsort(
            t.occ_hap.astype(np.int64) * (P + 1) + t.occ_start,
            kind="stable"))
        o_hap = t.occ_hap[o_order]
        o_start = t.occ_start[o_order].astype(np.int64)
        o_end = t.occ_end[o_order].astype(np.int64)
        o_w = t.occ_weight[o_order].astype(np.float64)
        hap_off = np.searchsorted(o_hap, np.arange(H + 1))

    def straddle_at(h: int, p: int) -> np.ndarray:
        """[L] vector: W[j, h, p] = weight of occurrences with
        s <= p-j-1, e >= p+1 in lane h (spans <= L+1 bound the s range)."""
        lo, hi = hap_off[h], hap_off[h + 1]
        s = o_start[lo:hi]
        a = np.searchsorted(s, p - L - 1)
        b = np.searchsorted(s, p, side="left")
        sel_e = o_end[lo + a:lo + b]
        keep = sel_e >= p + 1
        ss = s[a:b][keep]
        ww = o_w[lo + a:lo + b][keep]
        cw = np.concatenate([[0.0], np.cumsum(ww)])
        idx = np.searchsorted(ss, p - np.arange(L) - 1, side="right")
        return cw[idx]

    def entry_for(h: int, p: int) -> int:
        """Entry position achieving M[h,p]: the best of the L recent-entry
        candidates (A[q] - W[p-q, p]) and the q <= p-L prefix branch."""
        A_row, run_min_row, qlatest_row, _ = lane_arrays(h)
        if L == 0:
            return int(qlatest_row[p])
        Wv = straddle_at(h, p)
        best_v, best_q = np.inf, -1
        for j in range(min(L, p + 1)):
            cv = A_row[p - j] - Wv[j]
            if cv < best_v - 1e-9:
                best_v, best_q = cv, p - j
        if p - L >= 0 and run_min_row[p - L] < best_v - 1e-9:
            return int(qlatest_row[p - L])
        return best_q

    h = int(np.argmin(ends))
    p = int(walk_len[h]) - 1
    segments: list[tuple[int, int, int]] = []
    for _ in range(P * H + 1):
        q = entry_for(h, p)
        if q < 0:
            raise RuntimeError(
                f"backtrace: no entry point found for lane {h} position {p}")
        segments.append((h, q, p))
        v = int(t.state_vertex[h, q])
        A_row, _, _, start_entry_h = lane_arrays(h)
        entry_val = A_row[q] - t.S_row(h)[q]
        if q == 0 and entry_val >= -_EPS and start_entry_h >= -_EPS:
            break  # lane start
        # switch: find an achieving diverging source state for vertex v
        cand = order[tgt_off[v]:tgt_off[v + 1]]
        vals = M.sv_at(cand)
        j = int(np.argmin(vals))
        if not vals[j] <= ent[v] + _EPS:
            raise RuntimeError(
                f"backtrace: switch source mismatch at vertex {v} "
                f"(best source {vals[j]:.4f} > entry {ent[v]:.4f})")
        sel = cand[j]
        h, p = int(t.esrc_h[sel]), int(t.esrc_p[sel])
    else:
        raise RuntimeError("backtrace did not terminate")
    segments.reverse()

    res = result_from_segments(graph, t, anchors, segments, dp_objective)
    res.n_sweeps = n_sweeps
    res.solver_device = str(M.device)
    return res


def _target_order(t: SolverTables, n_vtx: int):
    """(order, tgt_off): the switch-source rows sorted by target vertex, and
    each vertex's offset into them, found once for every vertex, as a
    search with a Python int needle converts the whole int32 array on
    each call."""
    order = np.argsort(t.esrc_target, kind="stable")
    return order, np.searchsorted(t.esrc_target[order],
                                  np.arange(n_vtx + 1, dtype=np.int32))


def result_from_segments(graph: PangenomeGraph, t: SolverTables,
                         anchors: AnchorTables,
                         segments: list[tuple[int, int, int]],
                         dp_objective: float) -> DecodeResult:
    """DecodeResult from an expanded-graph path given as segments (the
    backtrace above, or the exact small-case enumeration): edge
    verification and exact scoring."""
    vparts, hparts = [], []
    for (sh, sq, sp) in segments:
        vparts.append(t.state_vertex[sh, sq:sp + 1])
        hparts.append(np.full(sp - sq + 1, sh, dtype=np.int32))
    vertices = np.concatenate(vparts).astype(np.int32)
    vertex_hap = np.concatenate(hparts)
    _verify_edges(graph, vertices, t.graph_memo)
    n_switches = len(segments) - 1
    matched_distinct, matched_total = _score_matches(anchors, segments)
    true_obj = t.R * n_switches + (anchors.n_model_kmers - matched_distinct)
    return DecodeResult(
        segments=list(segments), vertices=vertices, vertex_hap=vertex_hap,
        n_switches=n_switches,
        recombination_count=int((vertex_hap[1:] != vertex_hap[:-1]).sum()),
        matched_distinct=matched_distinct, matched_total=matched_total,
        dp_objective=dp_objective, true_objective=float(true_obj),
        n_sweeps=0,
    )


def _verify_edges(graph: PangenomeGraph, vertices: np.ndarray,
                  memo: dict | None) -> None:
    """Every consecutive pair must be a graph edge (the reference exits on
    a violation). The sorted edges are kept in the graph's memo."""
    if len(vertices) < 2:
        return
    packed_edges = memoized(memo, ("packed_edges",), lambda: np.sort(
        graph.edge_u.astype(np.int64) << 32 | graph.edge_v.astype(np.int64)))
    pairs = vertices[:-1].astype(np.int64) << 32 | vertices[1:].astype(np.int64)
    idx = np.searchsorted(packed_edges, pairs)
    idx_c = np.minimum(idx, len(packed_edges) - 1)
    ok = (idx < len(packed_edges)) & (packed_edges[idx_c] == pairs)
    if not ok.all():
        i = int(np.flatnonzero(~ok)[0])
        raise RuntimeError(
            f"decoded path uses non-edge {vertices[i]}->{vertices[i + 1]}")


def covered_occurrences(anchors: AnchorTables,
                        segments: list[tuple[int, int, int]]) -> np.ndarray:
    """Mask of the occurrences fully inside an in-lane segment (sh, sq, sp):
    occ_hap == sh, occ_start >= sq and occ_end <= sp for some segment. The
    segments sorted by (lane, start) and the running maximum of their ends
    within a lane answer every occurrence with one binary search, so a
    path of many switches (a low recombination penalty) costs one pass,
    not one pass per segment."""
    n = len(anchors.occ_hap)
    if n == 0 or not segments:
        return np.zeros(n, bool)
    seg = np.asarray(segments, np.int64)
    hap = anchors.occ_hap.astype(np.int64)
    # key = lane * span + position orders by lane, then position
    span = int(max(seg[:, 1:].max(), anchors.occ_end.max())) + 1
    order = np.argsort(seg[:, 0] * span + seg[:, 1], kind="stable")
    key = seg[order, 0] * span + seg[order, 1]
    reach = np.maximum.accumulate(seg[order, 0] * span + seg[order, 2])
    i = np.searchsorted(key, hap * span + anchors.occ_start, side="right") - 1
    ic = np.maximum(i, 0)
    return ((i >= 0) & (key[ic] // span == hap)
            & (reach[ic] >= hap * span + anchors.occ_end))


def _score_matches(anchors: AnchorTables,
                   segments: list[tuple[int, int, int]]) -> tuple[int, float]:
    """Occurrences fully contained in an in-lane segment: distinct k-mers
    and weighted total."""
    if len(anchors.occ_hap) == 0:
        return 0, 0.0
    covered = covered_occurrences(anchors, segments)
    return (len(np.unique(anchors.occ_kmer[covered])),
            float(anchors.occ_weight[covered].sum()))
