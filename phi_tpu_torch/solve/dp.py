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
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from phi_tpu_torch import state
from phi_tpu_torch.solve.prep import SolverTables

_INF = float("inf")

# seconds of the most recent solve (tables, exec, fetch) and the decode
# total; run_pipeline copies them into its timings as solve_*
LAST_TIMINGS: dict[str, float] = {}


def build_sbw(occ_hap, occ_start, occ_span, occ_w, H: int, P: int, L: int):
    """S, B (f32 [H, P]) and the straddle stack W (f32 [L, H, P]) from the
    occurrence columns: B[h,p] = weight ending <= p, S[h,p] = weight
    starting < p, W[j,h,p] = weight with start < p-j <= p < end."""
    dev = occ_w.device
    f32 = torch.float32
    end = occ_start + occ_span
    flat_end = occ_hap * P + end
    lo_base = occ_hap * P + occ_start + 1
    size = H * P + L + 2

    def prefix(diff):
        return torch.cumsum(diff[:H * P].reshape(H, P), 1)

    B = prefix(torch.zeros(size, dtype=f32, device=dev)
               .index_add_(0, flat_end, occ_w))
    start_next = occ_start + 1
    s_idx = torch.where(start_next < P, occ_hap * P + start_next, size - 1)
    S = prefix(torch.zeros(size, dtype=f32, device=dev)
               .index_add_(0, s_idx, occ_w))
    W = torch.empty((L, H, P), dtype=f32, device=dev)
    for j in range(L):
        wsel = torch.where(occ_span >= j + 2, occ_w, 0.0)
        diff = torch.zeros(size, dtype=f32, device=dev)
        diff.index_add_(0, (lo_base + j).clamp(max=size - 1), wsel)
        diff.index_add_(0, flat_end, -wsel)
        W[j] = prefix(diff)
    return S, B, W


def _ends(M, B, walk_len):
    H, P = M.shape
    valid = torch.arange(P, device=M.device)[None, :] < walk_len[:, None]
    D = torch.where(valid, M - B, _INF)
    ends = D[torch.arange(H, device=M.device), (walk_len - 1).clamp(min=0)]
    return torch.where(walk_len > 0, ends, _INF)


def solve_exact(S, B, W, esrc_h, esrc_p, esrc_target, state_vertex,
                walk_len, R: float, n_vtx: int, max_sweeps: int):
    """Exact-credit fixpoint: returns (M f32 [H, P], ends f32 [H], sweeps)."""
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
    optimistic one, the larger sweep count, the bound); LAST_TIMINGS is
    cleared, since bracket mode has no per-phase split."""
    device = torch.device(device)
    LAST_TIMINGS.clear()
    t = t.dense()
    eh, ep, et, sv, wl = state.solver_static(t, device)
    S, B = state.credit_tensors(t, device)
    R = float(np.float32(t.R))
    out, sweeps = [], 0
    for charge in (S, B):
        M, ends, n = solve_plain(charge, B, eh, ep, et, sv, wl, R, t.n_vtx,
                                 max_sweeps)
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
    value of the decodable relaxed path."""
    device = torch.device(device)
    LAST_TIMINGS.clear()
    t0 = time.time()
    H, P = t.state_vertex.shape
    eh, ep, et, sv, wl = state.solver_static(t, device)
    d = t.occ_dev
    if d is not None:
        oh, os_, osp, ow = d.dev_hap, d.dev_s, d.dev_span, d.dev_w
        if t.occ_weight is not None:
            ow = state.occ_weights(t.occ_weight, device)
    else:
        oh, os_, osp, ow = state.occ_tensors(
            t.occ_hap, t.occ_start, t.occ_end - t.occ_start, t.occ_weight,
            device)
    S, B, W = build_sbw(oh, os_, osp, ow, H, P, t.n_layers)
    _sync(device)
    t1 = time.time()
    M, ends_d, n_sweeps = solve_exact(S, B, W, eh, ep, et, sv, wl,
                                      float(np.float32(t.R)), t.n_vtx,
                                      max_sweeps)
    del W, S
    _sync(device)
    t2 = time.time()
    ent = esrc_ent(M, B, eh, ep, et, wl, t.n_vtx).cpu().numpy()
    ends = ends_d.cpu().numpy()
    sol = DeviceSolution(M, B, eh, ep, wl, ent)
    LAST_TIMINGS.update(tables=round(t1 - t0, 3), exec=round(t2 - t1, 3),
                        fetch=round(time.time() - t2, 3))
    _warn_cap(n_sweeps, max_sweeps)
    lb = float(t.const + ends.min()) if len(ends) else float(t.const)
    return sol, ends, n_sweeps, lb
