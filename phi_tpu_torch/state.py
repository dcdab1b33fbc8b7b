"""State carried across from the JAX package's numpy form to torch tensors.

PHI has no learned weights; the state both packages compute from is the
graph tensors, the read spectrum and its cuckoo table, the packed join
batches, the occurrence columns and the solver tables. Each function takes
the numpy arrays as `phi_tpu` (and this package's host code) holds them and
returns tensors on `device`. u32 columns widen to int64, since torch has no
uint32 shift, compare or add on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def graph_tensors(graph, device):
    """(walk_mat int64 [H, P] with -1 pads, walk_len int64 [H])."""
    return (_t(graph.walk_mat, torch.int64, device),
            _t(graph.walk_len, torch.int64, device))


def spectrum_u64(sp_hi, sp_lo) -> np.ndarray:
    """Read spectrum as uint64 keys (hi << 32) | lo, on the host."""
    return (np.asarray(sp_hi, np.uint64) << np.uint64(32)) \
        | np.asarray(sp_lo, np.uint64)


def spectrum_keys(sp_hi, sp_lo, device) -> torch.Tensor:
    """Read spectrum as int64 keys (hi << 32) | lo (sorted like (hi, lo))."""
    return _t(spectrum_u64(sp_hi, sp_lo).view(np.int64), torch.int64, device)


def cuckoo_tensors(ck, device):
    """A make_cuckoo table (Thi, Tlo, Tid, seed, M) as (tkey int64 [M],
    tid int64 [M], seed int); empty slots hold key -1."""
    Thi, Tlo, Tid, seed, _M = ck
    return (spectrum_keys(Thi, Tlo, device), _t(Tid, torch.int64, device),
            int(seed))


def words_tensor(words, device) -> torch.Tensor:
    """Packed 2-bit rows (uint32 [R, W]) as their int32 view."""
    return _t(np.ascontiguousarray(words, np.uint32).view(np.int32),
              torch.int32, device)


def batch_tensors(words, nodes, nvalid, left, base_node, hap, device):
    """One packed join batch: words (uint32 [R, W], passed as its int32
    view), the node starts (int32 [R, S_cap] offsets for the v3 routes, the
    uint8 [R, row_lanes] dense plane for v2) in their own dtype, and the
    int32 per-row columns."""
    nodes = torch.from_numpy(np.ascontiguousarray(nodes)).to(device)
    return (words_tensor(words, device), nodes,
            _t(nvalid, torch.int32, device), _t(left, torch.int32, device),
            _t(base_node, torch.int32, device), _t(hap, torch.int32, device))


def occ_tensors(occ_hap, occ_start, occ_span, occ_weight, device):
    """Occurrence columns: (hap, start, span int64 [n], weight f32 [n])."""
    return (_t(occ_hap, torch.int64, device), _t(occ_start, torch.int64, device),
            _t(occ_span, torch.int64, device),
            _t(occ_weight, torch.float32, device))


def occ_weights(occ_weight, device) -> torch.Tensor:
    """A round's occurrence weights (f32 [n]) for device-resident columns."""
    return _t(occ_weight, torch.float32, device)


def solver_static(t, device):
    """The weight-independent solver inputs of a SolverTables:
    (esrc_h, esrc_p, esrc_target, state_vertex, walk_len), int64."""
    return (_t(t.esrc_h, torch.int64, device),
            _t(t.esrc_p, torch.int64, device),
            _t(t.esrc_target, torch.int64, device),
            _t(t.state_vertex, torch.int64, device),
            _t(t.walk_len, torch.int64, device))


def credit_tensors(t, device):
    """The dense host S and B of a bracket-mode SolverTables (f32 [H, P])."""
    return _t(t.S, torch.float32, device), _t(t.B, torch.float32, device)
