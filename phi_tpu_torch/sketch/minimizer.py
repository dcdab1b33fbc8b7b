"""The host join of the hit path: the port's counterpart of the host half
of `phi_tpu/sketch/minimizer.py`.

The hit path joins each haplotype's minimizers against the sorted read
spectrum and returns per-haplotype (n_minimizers, hit positions, hit
spectrum ids). Its device half is `sketch.kernels.join_many` (the rows
kernel). Its host half is here, in the native library, for what the rows
kernel does not take:
  * `sketch_join_walks`: every haplotype, each walk streamed node by node
    from the graph tensors, threaded across haplotypes; the route for
    k > 31 (the 64-bit folds of the 126-bit k-mers, as the read spectrum
    holds them) and for k + w - 2 beyond the kernel's halo;
  * `host_join_one`: one sequence, for the walks holding N that
    `join_many` hands back as None.
Both need the native library and raise without it; there is no Python
scan to fall back on.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from phi_tpu_torch import native
from phi_tpu_torch.state import spectrum_u64

# spectra larger than this share a first-probe table (native.join_accel)
_ACCEL_MIN_KEYS = 1 << 16


def _accel(sp_key: np.ndarray):
    return native.join_accel(sp_key) if len(sp_key) > _ACCEL_MIN_KEYS \
        else None


def host_join_one(codes: np.ndarray, k: int, w: int, sp_hi, sp_lo,
                  sp_key: np.ndarray | None = None, accel=None
                  ) -> tuple[int, np.ndarray, np.ndarray]:
    """(n_minimizers, hit positions int32, hit spectrum ids int32) of one
    sequence, which may hold N, on the native scan and join. Pass sp_key
    and accel to share them across calls."""
    if sp_key is None:
        sp_key = spectrum_u64(sp_hi, sp_lo)
    if accel is None:
        accel = _accel(sp_key)
    return native.hap_join_native(codes, k, w, sp_key, accel)


def _threaded(fn, n: int) -> list:
    """fn(0) .. fn(n - 1) on a pool of native.pool_threads() threads (the
    native scans release the GIL)."""
    if n <= 1:
        return [fn(i) for i in range(n)]
    with ThreadPoolExecutor(max_workers=min(native.pool_threads(), n)) as ex:
        return list(ex.map(fn, range(n)))


def host_join_many(seqs: list[np.ndarray], idx: list[int], k: int, w: int,
                   sp_hi, sp_lo) -> list:
    """host_join_one of the sequences seqs[i] for i in idx, threaded, with
    one key array and first-probe table shared."""
    sp_key = spectrum_u64(sp_hi, sp_lo)
    accel = _accel(sp_key)
    return _threaded(lambda j: host_join_one(seqs[idx[j]], k, w, sp_hi,
                                             sp_lo, sp_key, accel), len(idx))


def sketch_join_walks(graph, k: int, w: int, sp_hi, sp_lo
                      ) -> list[tuple[int, np.ndarray, np.ndarray]]:
    """The hit path's join of every haplotype on the host: each walk read
    node by node from the graph tensors, threaded across haplotypes, with
    the semantics of host_join_one."""
    sp_key = spectrum_u64(sp_hi, sp_lo)
    accel = _accel(sp_key)
    g = graph.gfa

    def one(h: int):
        walk = graph.walk_mat[h, :graph.walk_len[h]]
        return native.hap_join_walk_native(
            g.seq_code, g.node_off, walk, int(g.node_len[walk].sum()), k, w,
            sp_key, accel)

    return _threaded(one, graph.num_walks)
