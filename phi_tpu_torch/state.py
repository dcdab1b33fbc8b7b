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


def host_batch(words, nodes, nvalid, left, base_node, hap, pin: bool):
    """One packed join batch as host tensors: words (uint32 [R, W], as its
    int32 view), the node starts (int32 [R, S_cap] offsets for the v3
    routes, the uint8 [R, row_lanes] dense plane for v2) in their own
    dtype, and the int32 per-row columns; in page-locked memory when `pin`,
    so that upload copies them asynchronously."""
    out = (np.ascontiguousarray(words, np.uint32).view(np.int32),
           np.ascontiguousarray(nodes),
           *(np.ascontiguousarray(a, np.int32)
             for a in (nvalid, left, base_node, hap)))
    out = tuple(torch.from_numpy(a) for a in out)
    return tuple(t.pin_memory() for t in out) if pin else out


def upload(tensors, device) -> tuple:
    """Host tensors on `device`: from page-locked memory a copy on the
    current stream, ordered before the kernels that read it, with no wait
    on the host."""
    return tuple(t.to(device, non_blocking=True) for t in tensors)


def batch_tensors(words, nodes, nvalid, left, base_node, hap, device):
    """One packed join batch on `device` (host_batch's tensors)."""
    return upload(host_batch(words, nodes, nvalid, left, base_node, hap,
                             pin=False), device)


def fetch(t: torch.Tensor):
    """Start copying a device tensor to the host; `fetched` waits for it.
    From a card the copy lands in page-locked memory behind the work
    queued before it, and the host goes on meanwhile."""
    if t.device.type != "cuda":
        return t, None
    host = t.to("cpu", non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return host, done


def fetched(pending) -> np.ndarray:
    """The numpy array of a fetch, once its copy has landed."""
    host, done = pending
    if done is not None:
        done.synchronize()
    return host.numpy()


def occ_index_tensors(occ_hap, occ_start, occ_span, device):
    """Occurrence index columns: (hap, start, span int64 [n])."""
    return (_t(occ_hap, torch.int64, device), _t(occ_start, torch.int64, device),
            _t(occ_span, torch.int64, device))


def occ_tensors(occ_hap, occ_start, occ_span, occ_weight, device):
    """Occurrence columns: (hap, start, span int64 [n], weight f32 [n])."""
    return occ_index_tensors(occ_hap, occ_start, occ_span, device) + (
        _t(occ_weight, torch.float32, device),)


def occ_weights(occ_weight, device) -> torch.Tensor:
    """A round's occurrence weights (f32 [n]) for device-resident columns."""
    return _t(occ_weight, torch.float32, device)


def esrc_tensors(t, device):
    """The switch sources of a SolverTables: (esrc_h, esrc_p, esrc_target),
    int64."""
    return (_t(t.esrc_h, torch.int64, device),
            _t(t.esrc_p, torch.int64, device),
            _t(t.esrc_target, torch.int64, device))


def lane_tensors(t, device):
    """The lane tables of a SolverTables: (state_vertex, walk_len), int64."""
    return (_t(t.state_vertex, torch.int64, device),
            _t(t.walk_len, torch.int64, device))


def solver_static(t, device):
    """The weight-independent solver inputs of a SolverTables:
    (esrc_h, esrc_p, esrc_target, state_vertex, walk_len), int64."""
    return esrc_tensors(t, device) + lane_tensors(t, device)


def credit_tensors(t, device):
    """The dense host S and B of a bracket-mode SolverTables (f32 [H, P])."""
    return _t(t.S, torch.float32, device), _t(t.B, torch.float32, device)
