"""Exact Lagrangian branch-and-bound over duplicate-k-mer credit: the
jax-free counterpart of `phi_tpu/solve/bnb.py`, the escalation that
replaces Gurobi's unconditional exactness
(ILP_index.cpp:1413-1418) beyond the exhaustive-enumeration scale.

The relaxation's slack against the distinct-k-mer objective has exactly two
sources, for any fixed multipliers mu in [0,1]:
  * duplicate credit: a path covering m >= 2 live occurrences of k-mer i
    over-collects mu_i*(m-1);
  * uncovered slack: an uncovered k-mer contributes 1 to the true
    objective but only mu_i to the bound's constant.

Each B&B node carries (zero-mask over occurrences, mu). Node evaluation
runs a bounded coordinate ascent: solve the exact-credit DP; if the decoded
path has duplicate credit, BRANCH on the most-duplicated k-mer i
(occurrence-partition rule, exact for any fixed mu):
    child j (one per covered occurrence o_j of i): zero every occurrence
        of i except o_j — any path covering i via o_j is scored exactly;
    child 0: zero the covered set, keep i's other occurrences — exact for
        paths covering i elsewhere (or not at all).
If instead the path is duplicate-free but the gap is open, the slack is
uncovered k-mers with mu_i < 1 — raise those to 1 and re-solve (pure bound
ascent, same node). Each branch permanently removes live occurrences, so
the tree is finite; best-first order + pruning close real-data gaps in a
handful of nodes.

Every node evaluation is one exact-credit DP solve with modified
occurrence weights; only the weight vector is uploaded per node (the
occurrence index columns stay on the device).
"""

from __future__ import annotations

import dataclasses
import heapq
import time

import numpy as np


def _covered_occurrences(anchors, segments) -> np.ndarray:
    covered = np.zeros(len(anchors.occ_hap), bool)
    for (sh, sq, sp) in segments:
        covered |= ((anchors.occ_hap == sh) & (anchors.occ_start >= sq)
                    & (anchors.occ_end <= sp))
    return covered


def branch_and_bound(graph, anchors, opt, tol: float,
                     mu: np.ndarray | None = None,
                     incumbent=None,
                     max_nodes: int = 48, max_seconds: float = 120.0,
                     ascent_rounds: int = 4,
                     solve_and_decode=None, layers=None, device="cpu"):
    """Close (or tighten) the duality gap exactly.

    mu: fixed per-k-mer multipliers in [0,1] for the ROOT node (pass the
    Lagrangian-refined ones — the bound is valid for any mu, and a tight
    start means branching only closes the residual). incumbent: best
    DecodeResult known so far (upper bound). Returns
    (best DecodeResult, certified_bound); on budget exhaustion the bound
    is the best proven so far (still valid). device: where each node's DP
    runs."""
    from phi_tpu_torch.pipeline import _solve_and_decode as _sad
    from phi_tpu_torch.solve.prep import build_solver_tables, solver_layers
    if layers is None:
        layers = solver_layers(graph, opt.k)

    n_occ = len(anchors.occ_hap)
    if n_occ == 0:
        return incumbent, (incumbent.dp_objective if incumbent else 0.0)
    kmax = int(anchors.occ_kmer.max()) + 1
    if mu is None:
        mu = np.ones(kmax, np.float32)
    model_kmers = np.unique(anchors.occ_kmer)

    def _default_sad(a, node_mu):
        # const = Σ_i mu_i over model k-mers, independent of the node's
        # occurrence zero-mask (zeroing an occurrence must not change the
        # per-k-mer constant, or the bound silently loosens per branch)
        t = build_solver_tables(
            graph, a, opt.recombination, layers,
            const_override=float(node_mu[model_kmers].sum()))
        return _sad(graph, t, a, opt, device)

    sad = solve_and_decode or _default_sad

    t0 = time.time()
    best = incumbent
    ub = incumbent.true_objective if incumbent else np.inf

    # heap entries: (bound, tie, zero_mask, mu)
    tie = 0
    heap: list = [(-np.inf, tie, np.zeros(n_occ, bool), mu)]
    closed: list[float] = []
    nodes = 0

    while heap and nodes < max_nodes and time.time() - t0 < max_seconds:
        bound, _, zmask, nmu = heapq.heappop(heap)
        if bound >= ub - tol:
            tie += 1  # unique tie-breaker: heap tuples must never compare
            heapq.heappush(heap, (bound, tie, zmask, nmu))  # the arrays
            break  # best-first: every open node is certified away
        nodes += 1
        node_bound = bound
        branched = False
        for _ in range(ascent_rounds + 1):
            w = np.where(zmask, np.float32(0), nmu[anchors.occ_kmer])
            res = sad(dataclasses.replace(anchors, occ_weight=w), nmu)
            node_bound = max(node_bound, res.dp_objective)
            if res.true_objective < ub:
                ub = res.true_objective
                best = res
            if node_bound >= ub - tol:
                break
            covered = _covered_occurrences(anchors, res.segments) \
                & ~zmask & (w > 0)
            mult = np.bincount(anchors.occ_kmer[covered], minlength=kmax)
            dups = np.flatnonzero(mult >= 2)
            if len(dups):
                # branch on the k-mer with the most duplicate weight
                i = int(dups[np.argmax(mult[dups] * nmu[dups])])
                occ_i = anchors.occ_kmer == i
                on_path = occ_i & covered
                # covered k-mer: its mu is exact credit 1 in each child
                cmu = nmu.copy()
                cmu[i] = 1.0
                for j in np.flatnonzero(on_path):
                    m = zmask | occ_i
                    m[j] = False
                    tie += 1
                    heapq.heappush(heap, (node_bound, tie, m, cmu))
                tie += 1
                heapq.heappush(heap, (node_bound, tie, zmask | on_path,
                                      cmu))
                branched = True
                break
            # duplicate-free: remaining slack is uncovered mu < 1 — ascend
            cov_k = np.zeros(kmax, bool)
            cov_k[anchors.occ_kmer[covered]] = True
            lift = ~cov_k & (nmu < 1.0)
            # only k-mers with any live occurrence matter for the constant
            live_k = np.zeros(kmax, bool)
            live_k[anchors.occ_kmer[~zmask]] = True
            lift &= live_k
            if not lift.any():
                closed.append(res.true_objective
                              if node_bound >= res.true_objective - 1e-9
                              else node_bound)
                branched = True  # node resolved (exact or stuck at bound)
                break
            nmu = nmu.copy()
            nmu[lift] = 1.0
        if not branched:
            # ascent budget exhausted without branching: keep the node open
            # with its improved bound (still valid)
            tie += 1
            heapq.heappush(heap, (node_bound, tie, zmask, nmu))
            if node_bound >= ub - tol:
                continue
            # avoid spinning on the same node forever when out of ideas
            if nodes >= max_nodes:
                break

    open_bounds = [b for (b, _, _, _) in heap]
    certified = min(open_bounds + closed) if (open_bounds or closed) else ub
    certified = min(certified, ub)
    return best, float(certified)
