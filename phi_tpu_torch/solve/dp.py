"""The DP solver on the device: the torch counterpart of
`phi_tpu/solve/dp.py`, its exact-credit solve and its bracket solve.

Each sweep:
  D[h,p]   = M[h,p] - B[h,p]                       (exit values)
  Ent[v]   = min over diverging source states of D (one segment-min)
  E[h,p]   = R + Ent[vertex(h,p)]; lane starts also get entry 0
  A[h,p]   = E + S
  M'[h,p]  = min(prefix-min of A shifted by L, A[p-j] - W[j] for j < L)
The fixpoint loop stops as the reference's does: at least 2 sweeps, then
when no entry drops by more than 1e-4, capped at max_sweeps. Shapes are the
instance's own (no padding to buckets). The bracket solve (solve_dp_both),
for spans past MAX_LAYERS straddle layers, runs the sweep with no layers
(L = 0) twice: once with the search charge S and once with the optimistic
charge S := B, whose value is the bound.

W [L, H, P] is the solve's largest array. Where the memory model says the
materialized solve would not fit the card's free memory (stream_w), the
sweep reads a StreamedW instead, which rebuilds each layer from the
occurrence columns when it is read: the same values, L scatters and
cumsums more per sweep, and no stack.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from phi_tpu_torch import state
from phi_tpu_torch.graph.pangenome import memoized
from phi_tpu_torch.solve.prep import SolverTables
from phi_tpu_torch.trace import span

_INF = float("inf")


def solver_static(t, device):
    """state.solver_static, kept per device in the graph's memo: one upload
    of the switch sources and lane tables per graph, which every round
    and every item on the held panel reads."""
    return memoized(t.graph_memo, ("solver_static", str(torch.device(device))),
                    lambda: state.solver_static(t, device))


class StreamedW:
    """The straddle stack W [L, H, P] of build_sbw without the stack:
    W[j] is rebuilt from the occurrence columns at each use, by build_sbw's
    own scatter and cumsum, so it holds the same values (bit-equal where
    every scatter sum is exact, as at unit weights; a CUDA index_add_ of
    fractional weights adds in no fixed order). solve_exact reads it as it
    reads a materialized W: W.shape[0] layers, W[j] one [H, P] plane."""

    def __init__(self, occ_hap, occ_start, occ_span, occ_w, H: int, P: int,
                 L: int):
        self.shape = (L, H, P)
        self.end = occ_hap * P + occ_start + occ_span
        self.lo = occ_hap * P + occ_start + 1
        self.span = occ_span
        self.w = occ_w

    def __getitem__(self, j: int) -> torch.Tensor:
        L, H, P = self.shape
        size = H * P + L + 2
        wsel = torch.where(self.span >= j + 2, self.w, 0.0)
        diff = torch.zeros(size, dtype=torch.float32, device=self.w.device)
        diff.index_add_(0, (self.lo + j).clamp(max=size - 1), wsel)
        diff.index_add_(0, self.end, -wsel)
        return torch.cumsum(diff[:H * P].reshape(H, P), 1)


def build_sbw(occ_hap, occ_start, occ_span, occ_w, H: int, P: int, L: int):
    """S, B (f32 [H, P]) and the straddle stack W (f32 [L, H, P]) from the
    occurrence columns: B[h,p] = weight ending <= p, S[h,p] = weight
    starting < p, W[j,h,p] = weight with start < p-j <= p < end."""
    dev = occ_w.device
    f32 = torch.float32
    layers = StreamedW(occ_hap, occ_start, occ_span, occ_w, H, P, L)
    size = H * P + L + 2

    def prefix(diff):
        return torch.cumsum(diff[:H * P].reshape(H, P), 1)

    B = prefix(torch.zeros(size, dtype=f32, device=dev)
               .index_add_(0, layers.end, occ_w))
    start_next = occ_start + 1
    s_idx = torch.where(start_next < P, occ_hap * P + start_next, size - 1)
    S = prefix(torch.zeros(size, dtype=f32, device=dev)
               .index_add_(0, s_idx, occ_w))
    W = torch.empty((L, H, P), dtype=f32, device=dev)
    for j in range(L):
        W[j] = layers[j]
    return S, B, W


def stream_w(H: int, P: int, L: int, n_occ: int, device) -> bool:
    """Rebuild W's layers in every sweep (StreamedW) instead of holding the
    [L, H, P] stack? PHI_TPU_STREAM_W=1/0 forces the choice on any device.
    Otherwise the CPU never streams; on a card the solve streams when the
    memory model's materialized solve (S, B, M, the sweep's working set
    and W) exceeds the free device memory: what CUDA reports free
    plus what the caching allocator holds reserved but unallocated.
    PHI_TPU_STREAM_W_GB, when set, replaces that with a fixed cap on the
    stack alone (the reference's rule)."""
    forced = os.environ.get("PHI_TPU_STREAM_W")
    if forced in ("0", "1"):
        return forced == "1"
    device = torch.device(device)
    if device.type != "cuda":
        return False
    cap_gb = os.environ.get("PHI_TPU_STREAM_W_GB")
    if cap_gb is not None:
        return L * H * P * 4 > float(cap_gb) * (1 << 30)
    from phi_tpu_torch.eval.hbm_budget import solve_bytes
    free = torch.cuda.mem_get_info(device)[0] + (
        torch.cuda.memory_reserved(device)
        - torch.cuda.memory_allocated(device))
    return solve_bytes(H, P, L, n_occ, stream_w=False) > free


def _ends(M, B, walk_len):
    H, P = M.shape
    valid = torch.arange(P, device=M.device)[None, :] < walk_len[:, None]
    D = torch.where(valid, M - B, _INF)
    ends = D[torch.arange(H, device=M.device), (walk_len - 1).clamp(min=0)]
    return torch.where(walk_len > 0, ends, _INF)


def solve_exact(S, B, W, esrc_h, esrc_p, esrc_target, state_vertex,
                walk_len, R: float, n_vtx: int, max_sweeps: int):
    """Exact-credit fixpoint: returns (M f32 [H, P], ends f32 [H], sweeps).
    W is the materialized stack or a StreamedW: the same sweep reads
    either, one layer at a time."""
    H, P = S.shape
    L = W.shape[0]
    dev = S.device
    cols = torch.arange(P, device=dev)[None, :]
    valid = cols < walk_len[:, None]
    vtx_clip = state_vertex.clamp(min=0)
    has_vtx = state_vertex >= 0
    pad = torch.full((H, L), _INF, dtype=S.dtype, device=dev)

    def sweep(M):
        D = torch.where(valid, M - B, _INF)
        ent = torch.full((n_vtx,), _INF, dtype=S.dtype, device=dev)
        ent.scatter_reduce_(0, esrc_target, D[esrc_h, esrc_p], "amin")
        e_state = torch.where(has_vtx, ent[vtx_clip] + R, _INF)
        e_state[:, 0] = e_state[:, 0].clamp(max=0.0)
        A = torch.where(valid, e_state + S, _INF)
        scan = torch.cummin(A, 1).values
        # entries at q <= p - L: the S charge is exact there
        Mn = torch.where(cols >= L, torch.roll(scan, L, 1), _INF)
        if L:
            # recent entries q = p - j, j < L: subtract open straddlers
            Apad = torch.cat([pad, A], 1)
            for j in range(L):
                Mn = torch.minimum(Mn, Apad[:, L - j:L - j + P] - W[j])
        return Mn

    M = torch.full((H, P), _INF, dtype=S.dtype, device=dev)
    it, changed = 0, True
    while it < max(max_sweeps, 2) and (it < 2 or changed):
        Mn = sweep(M)
        changed = bool((Mn < M - 1e-4).any())
        M = Mn
        it += 1
    return M, _ends(M, B, walk_len), it


def solve_plain(S, B, esrc_h, esrc_p, esrc_target, state_vertex, walk_len,
                R: float, n_vtx: int, max_sweeps: int):
    """The fixpoint without the straddle correction (the port of
    `_solve_jit`): entry charge S, exit reward B, the stop rule of
    solve_exact. Returns (M f32 [H, P], ends f32 [H], sweeps)."""
    W = S.new_empty((0,) + tuple(S.shape))
    return solve_exact(S, B, W, esrc_h, esrc_p, esrc_target, state_vertex,
                       walk_len, R, n_vtx, max_sweeps)


def esrc_ent(M, B, esrc_h, esrc_p, esrc_target, walk_len, n_vtx: int):
    """Per-vertex entry minima of the fixpoint (all decode needs densely)."""
    valid = esrc_p < walk_len[esrc_h]
    sv = torch.where(valid, M[esrc_h, esrc_p] - B[esrc_h, esrc_p], _INF)
    ent = torch.full((n_vtx,), _INF, dtype=M.dtype, device=M.device)
    return ent.scatter_reduce_(0, esrc_target, sv, "amin")


@dataclasses.dataclass
class DeviceSolution:
    """Solver output kept on the device. decode_path duck-types on sv_at:
    it reads the per-vertex entry minima (ent) and fetches switch-source
    exit values lazily, one small gather per visited switch vertex."""
    M: torch.Tensor
    B: torch.Tensor
    esrc_h: torch.Tensor
    esrc_p: torch.Tensor
    walk_len: torch.Tensor
    ent: np.ndarray

    @property
    def device(self) -> torch.device:
        return self.M.device

    def sv_at(self, idx: np.ndarray) -> np.ndarray:
        if len(idx) == 0:
            return np.zeros(0, np.float32)
        i = torch.from_numpy(np.asarray(idx, np.int64)).to(self.M.device)
        e = self.esrc_h[i]
        p = self.esrc_p[i]
        out = torch.where(p < self.walk_len[e], self.M[e, p] - self.B[e, p],
                          _INF)
        return out.cpu().numpy()


def _warn_cap(n_sweeps: int, max_sweeps: int) -> None:
    if n_sweeps >= max_sweeps:
        import sys
        print(f"[W::solve_dp] sweep cap {max_sweeps} reached; solution may be "
              "suboptimal (raise Options.max_sweeps)", file=sys.stderr)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def solve_dp_both(t: SolverTables, max_sweeps: int, device):
    """The bracket solve, for tables with n_layers None (spans past
    MAX_LAYERS layers): the search fixpoint (S, B), whose entry charge
    S[q] under-counts a visit's credit, so its value is a heuristic score,
    and the optimistic fixpoint (B, B), whose charge B[q] over-counts it,
    so its minimum is a valid lower bound. Both are decodable paths.
    Returns ((DeviceSolution, ends), (DeviceSolution, ends) of the
    optimistic one, the larger sweep count, the bound). Spans: tables,
    and exec and fetch of both fixpoints."""
    device = torch.device(device)
    with span("tables"):
        t = t.dense()
        eh, ep, et, sv, wl = solver_static(t, device)
        S, B = state.credit_tensors(t, device)
    R = float(np.float32(t.R))
    out, sweeps = [], 0
    for charge in (S, B):
        with span("exec"):
            M, ends, n = solve_plain(charge, B, eh, ep, et, sv, wl, R,
                                     t.n_vtx, max_sweeps)
        with span("fetch"):
            ent = esrc_ent(M, B, eh, ep, et, wl, t.n_vtx).cpu().numpy()
            out.append((DeviceSolution(M, B, eh, ep, wl, ent),
                        ends.cpu().numpy()))
        sweeps = max(sweeps, n)
    _warn_cap(sweeps, max_sweeps)
    ends_opt = out[1][1]
    lb = float(t.const + ends_opt.min()) if len(ends_opt) else float(t.const)
    return out[0], out[1], sweeps, lb


def solve_dp(t: SolverTables, max_sweeps: int, device):
    """Returns (DeviceSolution, ends f32 [H], n_sweeps, dp_objective); the
    objective is both a lower bound on the distinct-k-mer optimum and the
    value of the decodable relaxed path. W is materialized, or streamed
    where stream_w says so; a solve that runs out of memory is not
    retried streamed. Spans: tables, exec and fetch."""
    device = torch.device(device)
    with span("tables"):
        H, P = t.state_vertex.shape
        eh, ep, et, sv, wl = solver_static(t, device)
        d = t.occ_dev
        if d is not None:
            oh, os_, osp, ow = d.dev_hap, d.dev_s, d.dev_span, d.dev_w
            if t.occ_weight is not None:
                ow = state.occ_weights(t.occ_weight, device)
        else:
            # the index columns once per ladder (kept with the sample),
            # each round's weights fresh
            oh, os_, osp = memoized(
                t.sample_memo, ("occ_index", str(device)),
                lambda: state.occ_index_tensors(
                    t.occ_hap, t.occ_start, t.occ_end - t.occ_start,
                    device))
            ow = state.occ_weights(t.occ_weight, device)
        L = t.n_layers
        streamed = stream_w(H, P, L, int(ow.shape[0]), device)
        S, B, W = build_sbw(oh, os_, osp, ow, H, P, 0 if streamed else L)
        if streamed:
            W = StreamedW(oh, os_, osp, ow, H, P, L)
        _sync(device)
    with span("exec"):
        M, ends_d, n_sweeps = solve_exact(S, B, W, eh, ep, et, sv, wl,
                                          float(np.float32(t.R)), t.n_vtx,
                                          max_sweeps)
        del W, S
        _sync(device)
    with span("fetch"):
        ent = esrc_ent(M, B, eh, ep, et, wl, t.n_vtx).cpu().numpy()
        ends = ends_d.cpu().numpy()
    sol = DeviceSolution(M, B, eh, ep, wl, ent)
    _warn_cap(n_sweeps, max_sweeps)
    lb = float(t.const + ends.min()) if len(ends) else float(t.const)
    return sol, ends, n_sweeps, lb
