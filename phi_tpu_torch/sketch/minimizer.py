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

The read spectrum is here too: the native per-read scan
(`native_spectrum`, the default on one device) and the device read sketch
(`sketch_read_concat` on a mesh's devices or under
PHI_TPU_DEVICE_READ_SKETCH=1, and `sketch_read_batch`), the port of
`_sketch_masked_jit` and its callers. The spectrum is a set: the distinct
minimizer keys of the windows that lie wholly inside one read and hold a
k-mer without N. The seq kernel gives every window lane's minimizer key
and a position of -1 on a window of dead k-mers, so a shard's keys are
the keys at (pos >= 0) & window_ok, deduplicated on its device; the
JAX package's emit dedup only thins runs of equal keys, which cannot
change a set.
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from phi_tpu_torch import native
from phi_tpu_torch.parallel.dist import read_shard_bounds
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


# ------------------------------------------------------- the read spectrum

NO_NATIVE = ("the native library is unavailable "
             "(make -C native needs g++ and zlib)")
DEVICE_READ_SKETCH = "PHI_TPU_DEVICE_READ_SKETCH"
# lanes per seq row of the device read sketch: the kernel's int32 lane
# positions, and (on a card) the free memory at 48 B a lane (13 B of
# outputs, the selected keys and the dedup's sort)
_ROW_MAX_LANES = 1 << 30
_BYTES_PER_LANE = 48


def sorted_unique(keys: np.ndarray) -> np.ndarray:
    """np.unique of a 1-D key array by a sort and an adjacent compare:
    NumPy releases whose np.unique takes a hash path spend seconds there
    on the millions of keys of a read spectrum."""
    keys = np.sort(keys)
    if len(keys) > 1:
        keys = keys[np.concatenate(([True], keys[1:] != keys[:-1]))]
    return keys


def _split_keys(key: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return ((key >> np.uint64(32)).astype(np.uint32),
            (key & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _empty_spectrum() -> tuple[np.ndarray, np.ndarray]:
    z = np.zeros(0, np.uint32)
    return z, z.copy()


def native_spectrum(concat, off, k: int, w: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Distinct canonical minimizers of the reads as sorted (hi, lo)
    uint32, from the native per-read scan; for k > 31 the keys are the
    64-bit folds (fold128_64) of the 126-bit canonical k-mers."""
    if concat is None or len(concat) < w + k - 1:
        return _empty_spectrum()
    keys = native.spectrum_native(concat, off, k, w)
    if keys is None:
        raise RuntimeError(NO_NATIVE)
    return _split_keys(sorted_unique(keys))


def sketch_read_concat(concat, off, k: int, w: int, devices=None, *,
                       device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Distinct minimizer spectrum of the ragged read concatenation (read
    i is concat[off[i]:off[i+1]]) as sorted (hi, lo) uint32.

    One device (devices None or of length 1) takes the native scan, unless
    PHI_TPU_DEVICE_READ_SKETCH=1 asks for the device read sketch there
    (on devices[0], else `device`). With more devices the reads are split
    into len(devices) contiguous shards (read_shard_bounds), each shard's
    keys are found on its own device by the seq kernel, and the union is a
    sorted dedup on the host. The device route takes k <= 31; with
    k + w - 2 beyond the kernel's halo it hands the reads to the native
    scan and says so on stderr, as the hit path's join does."""
    from phi_tpu_torch.sketch.kernels import HALO_PAD, NARROW_MAX_K
    if concat is None or len(concat) < w + k - 1:
        return _empty_spectrum()
    off = np.asarray(off, np.int64)
    devs = [torch.device(d) for d in devices] if devices else \
        [torch.device(device)]
    if len(devs) == 1 and os.environ.get(DEVICE_READ_SKETCH) != "1":
        return native_spectrum(concat, off, k, w)
    if k > NARROW_MAX_K:
        raise RuntimeError(
            f"k={k} > {NARROW_MAX_K} needs the native scanner: the device "
            "read sketch takes k <= 31")
    if k + w - 2 > HALO_PAD:
        print(f"[W::sketch_read_concat] k + w - 2 = {k + w - 2} is beyond "
              f"the seq kernel's halo ({HALO_PAD}); native read scan",
              file=sys.stderr)
        return native_spectrum(concat, off, k, w)
    n_reads = len(off) - 1
    parts = []
    for i, d in enumerate(devs):
        lo, hi = read_shard_bounds(n_reads, i, len(devs))
        if lo >= hi:
            continue
        parts.append(_concat_emissions(concat[off[lo]:off[hi]],
                                       off[lo:hi + 1] - off[lo], k, w,
                                       device=d))
    keys = np.concatenate(parts) if parts else np.zeros(0, np.uint64)
    return _split_keys(sorted_unique(keys))


def sketch_read_batch(codes: np.ndarray, k: int, w: int,
                      lengths: np.ndarray | None = None, *, device="cuda"
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Distinct minimizer spectrum of a padded read batch (uint8 [n, W],
    read i its first lengths[i] codes) as sorted (hi, lo) uint32, by the
    device read sketch on `device`. Without lengths, a read ends after its
    last code below 4 (code 4 is also a real N, so the trailing pad run is
    what is cut)."""
    if codes.shape[0] == 0 or codes.shape[1] < w + k - 1:
        return _empty_spectrum()
    if lengths is None:
        valid = codes < 4
        W = codes.shape[1]
        lengths = (W - np.argmax(valid[:, ::-1], axis=1)).astype(np.int32)
        lengths[~valid.any(axis=1)] = 0
    keys = _sketch_concat_emissions(codes, lengths, k, w, device)
    return _split_keys(sorted_unique(keys))


def _sketch_concat_emissions(codes: np.ndarray, lengths: np.ndarray,
                             k: int, w: int, device) -> np.ndarray:
    """Distinct minimizer keys (uint64) of a padded 2-D read batch: its
    reads concatenated in order, then _concat_emissions."""
    W = codes.shape[1]
    concat = codes[np.arange(W)[None, :] < lengths[:, None]]
    off = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=off[1:])
    return _concat_emissions(concat, off, k, w, device=device)


def _concat_emissions(concat: np.ndarray, off: np.ndarray, k: int, w: int,
                      device="cuda") -> np.ndarray:
    """Distinct minimizer keys (uint64) of concatenated reads with
    boundaries off. The window at lane a is valid for its read iff
    [a, a + k + w - 2] lies inside one read; that mask is built on
    `device` from a difference array (+1 at each read's first window, -1
    after its last, a cumulative sum)."""
    device = torch.device(device)
    total = len(concat)
    span = k + w - 1
    o = torch.from_numpy(np.ascontiguousarray(off, np.int64)).to(device)
    start, end = o[:-1], o[1:]
    fits = (end - start) >= span
    diff = torch.zeros(total + 1, dtype=torch.int32, device=device)
    one = torch.ones(int(fits.sum()), dtype=torch.int32, device=device)
    diff.scatter_add_(0, start[fits], one)
    diff.scatter_add_(0, (end - span + 1)[fits], -one)
    window_ok = torch.cumsum(diff[:total], 0) > 0
    return _masked_emissions(concat, window_ok, k, w, device=device)


def _row_lanes(device: torch.device) -> int:
    """Window lanes per seq row of the read sketch on `device`."""
    if device.type != "cuda":
        return _ROW_MAX_LANES
    free = torch.cuda.mem_get_info(device)[0]
    return max(1 << 20, min(_ROW_MAX_LANES, free // _BYTES_PER_LANE))


def _masked_emissions(concat: np.ndarray, window_ok, k: int, w: int,
                      device="cuda") -> np.ndarray:
    """Distinct keys (uint64) of the windows of concat at which window_ok
    (bool [len(concat)], on `device`) holds and which hold a k-mer without
    N. The windows run through the seq kernel in rows of _row_lanes
    lanes, each row's keys deduplicated on the device."""
    from phi_tpu_torch.sketch.kernels import _seq_tensors, sketch_seq
    device = torch.device(device)
    halo = k + w - 2
    n_windows = len(concat) - halo
    if n_windows <= 0:
        return np.zeros(0, np.uint64)
    window_ok = torch.as_tensor(window_ok, device=device)
    step = _row_lanes(device)
    parts = []
    for a in range(0, n_windows, step):
        n = min(step, n_windows - a)
        buf, nvalid = _seq_tensors(concat[a:a + n + halo], k, w, device)
        key, pos, _ = sketch_seq(buf, nvalid, k, w)
        sel = (pos[0, :n] >= 0) & window_ok[a:a + n]
        parts.append(torch.unique(key[0, :n][sel]))
        del key, pos, sel
    keys = torch.unique(torch.cat(parts)) if len(parts) > 1 else parts[0]
    return keys.cpu().numpy().view(np.uint64)
