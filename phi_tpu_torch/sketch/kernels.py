"""The rows3 haplotype sketch and join on the device.

`sketch_rows3` is the port of the Pallas TPU kernel
`phi_tpu/sketch/kernels.py:_make_kernel_rows3`. On a CUDA tensor it launches
the hand-written Hopper kernel in `csrc/rows3.cu` (built with nvcc on first
use into `_build/`, loaded with ctypes); on a CPU tensor it runs the plain
torch twin `sketch_rows3_torch`, which computes the same outputs over whole
rows in int64.

What bounds the kernel, and its design, are in the source note at the top
of `csrc/rows3.cu`: it is integer-ALU bound (key building and the
window-of-w minimum), and every block is independent because the TPU
kernel's grid carries (the dedup carry, the node-count carry, the roll
network compaction) become a one-base left context, per-block node offsets
and a block-wide scan.

Around the kernel, `join_rows3` is the port of `_pallas_join_rows3_ck`: the
2-bit unpack, the node-start plane, the cuckoo slot probe, the hit flatten
and the slot -> spectrum id remap, as torch ops.

Keys are int64: a k <= 31 canonical k-mer is (hi << 32) | lo, which orders
like the reference's (hi, lo) pair; a dead lane is -1, i.e. (UMAX, UMAX).
Packed intervals `se` are int64 holding the reference's u32 value
((s << 6) | min(e - s, 63)), UMAX32 on dead lanes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

BLK = 8192          # lanes per kernel block
HALO_PAD = 128      # right halo lanes; k + w - 2 must fit
SUPER_BLOCKS = 256  # blocks per row: 2,097,152 windows
ROWS = 8            # rows per batch
UMAX32 = 0xFFFFFFFF
DEAD_KEY = -1       # (UMAX, UMAX) as one int64

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc", "rows3.cu")
_BUILD_DIR = os.path.join(_PKG, "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]


# ----------------------------------------------------------- host packers

def pack_rows_2bit(seqs, rows, row_lanes: int) -> np.ndarray:
    """2-bit packing of batch rows: uint32 [R, row_lanes // 16], base j of
    each 16-base group in bits 2j. Codes must be A/C/G/T (< 4); pad rows
    (si < 0) and lanes past the sequence are 0."""
    R = len(rows)
    W = row_lanes // 16
    buf = np.zeros((R, row_lanes), np.uint8)
    for j, (si, start, nv, cont) in enumerate(rows):
        if si < 0:
            continue
        seg = seqs[si][start:start + row_lanes]
        buf[j, :len(seg)] = seg
    if buf.max(initial=0) >= 4:
        raise ValueError("pack_rows_2bit needs A/C/G/T codes (< 4)")
    c = buf.reshape(R, W, 16)
    out = np.zeros((R, W), np.uint32)
    for b in range(16):
        out |= c[:, :, b].astype(np.uint32) << np.uint32(2 * b)
    return out


def pack_row_left(seqs, rows) -> np.ndarray:
    """The base left of each row's first lane (int32 [R]): the code at
    start - 1 for a row that continues its walk, else -1. It stands in for
    the TPU kernel's dedup carry, so every row and batch is independent."""
    out = np.full(len(rows), -1, np.int32)
    for j, (si, start, nv, cont) in enumerate(rows):
        if si >= 0 and cont:
            out[j] = int(seqs[si][start - 1])
    return out


def hit_cap(w: int, super_blocks: int = SUPER_BLOCKS,
            rows_per_call: int = ROWS) -> int:
    """cap_total: the flattened hits one batch can hold (the reference's
    join_caps); a batch with more raises."""
    sup = super_blocks * BLK
    return 1 << max(15, (2 * rows_per_call * sup // (w + 1)).bit_length())


def block_cap(w: int) -> int:
    """Compacted slots per block, C: a power of two with ~1.6x headroom over
    the expected 2.36/(w+1) emission density."""
    c = 1 << max(8, (BLK * 33 // (10 * (w + 1))).bit_length())
    return min(c, BLK)


def row_base_nodes(cumlens, rows) -> np.ndarray:
    """Walk position (node index) at each row's start base."""
    out = np.zeros(len(rows), np.int32)
    for j, (si, start, nv, cont) in enumerate(rows):
        if si < 0:
            continue
        out[j] = np.searchsorted(cumlens[si], start, side="right") - 1
    return out


# ------------------------------------------------ device glue (torch ops)

def unpack_2bit(words: torch.Tensor, row_lanes: int) -> torch.Tensor:
    """uint8 codes [R, row_lanes] from the packed words (int32 view of the
    uint32 words; the arithmetic shift is harmless under the & 3)."""
    shifts = torch.arange(0, 32, 2, dtype=torch.int32, device=words.device)
    codes = (words[:, :, None] >> shifts) & 3
    return codes.to(torch.uint8).reshape(words.shape[0], row_lanes)


def delta_plane(starts: torch.Tensor, row_lanes: int) -> torch.Tensor:
    """Node-start-count plane uint8 [R, row_lanes] from per-row start
    offsets (int32 [R, S_cap], padded with row_lanes, which is dropped);
    saturates at 255."""
    R = starts.shape[0]
    plane = torch.zeros((R, row_lanes + 1), dtype=torch.int32,
                        device=starts.device)
    plane.scatter_add_(1, starts.long().clamp(max=row_lanes),
                       torch.ones_like(starts, dtype=torch.int32))
    return plane[:, :row_lanes].clamp(max=255).to(torch.uint8)


def block_node_offsets(nd: torch.Tensor, base_node: torch.Tensor,
                       n_blocks: int) -> torch.Tensor:
    """Node index before each block (int32 [R, SB]): base_node plus the
    exclusive prefix of per-block node-start totals."""
    R = nd.shape[0]
    tot = nd[:, :n_blocks * BLK].reshape(R, n_blocks, BLK).sum(
        2, dtype=torch.int64)
    excl = torch.cumsum(tot, 1) - tot
    return (excl + base_node.long()[:, None]).to(torch.int32)


# ------------------------------------------------------- rows3 and twin

def _check_rows3(codes, nd, nvalid, left, node_off, k, w, C) -> None:
    if not 1 <= k <= 31:
        raise ValueError(f"rows3 needs 1 <= k <= 31, got k={k}")
    if w < 1 or k + w - 2 > HALO_PAD:
        raise ValueError(f"rows3 needs k + w - 2 <= {HALO_PAD}, got k={k} "
                         f"w={w}")
    if not 1 <= C <= BLK:
        raise ValueError(f"rows3 needs 1 <= C <= {BLK}, got C={C}")
    if codes.dim() != 2 or node_off.dim() != 2:
        raise ValueError("codes [R, L] and node_off [R, SB] expected")
    R, L = codes.shape
    SB = node_off.shape[1]
    want = {"codes": (codes, torch.uint8, (R, (SB + 1) * BLK)),
            "nd": (nd, torch.uint8, (R, (SB + 1) * BLK)),
            "nvalid": (nvalid, torch.int32, (R,)),
            "left": (left, torch.int32, (R,)),
            "node_off": (node_off, torch.int32, (R, SB))}
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"rows3 {name}: want {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != codes.device:
            raise ValueError(f"rows3 {name} on {t.device}, codes on "
                             f"{codes.device}")
        if not t.is_contiguous():
            raise ValueError(f"rows3 {name} is not contiguous")


def _wmin_step(key, pos, s):
    """Pairwise minimum of windows i and i + s, ties to the right one."""
    a, b = key[:, :-s], key[:, s:]
    take_b = b <= a
    return torch.where(take_b, b, a), torch.where(take_b, pos[:, s:],
                                                  pos[:, :-s])


def sketch_rows3_torch(codes, nd, nvalid, left, node_off, k: int, w: int,
                       C: int):
    """Plain torch twin of the rows3 kernel (same inputs and outputs).

    codes, nd: uint8 [R, (SB+1)*BLK]; nvalid, left: int32 [R];
    node_off: int32 [R, SB]. Returns (key int64 [R, SB*C],
    se int64 [R, SB*C], cnt int32 [R, SB]): per block, the emitted
    minimizers left-compacted into C slots (dead past the count) and the
    exact emitted count."""
    _check_rows3(codes, nd, nvalid, left, node_off, k, w, C)
    R = codes.shape[0]
    SB = node_off.shape[1]
    n_out = SB * BLK
    dev = codes.device
    i64 = torch.int64
    # index i holds lane i - 1; lane -1 is the left base (0 when none)
    x = torch.cat([left.clamp(min=0).to(i64)[:, None], codes.to(i64)], 1)
    nk = n_out + w
    fwd = torch.zeros((R, nk), dtype=i64, device=dev)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        c = x[:, j:j + nk]
        fwd = (fwd << 2) | c
        rc |= (3 - c) << (2 * j)
    key = torch.minimum(fwd, rc)
    pos = torch.arange(nk, dtype=i64, device=dev).expand(R, nk)
    sdl = 1
    while sdl * 2 <= w:
        key, pos = _wmin_step(key, pos, sdl)
        sdl *= 2
    if w > sdl:
        key, pos = _wmin_step(key, pos, w - sdl)
    # windows at lanes -1 .. n_out-1; q = lane of the selected k-mer
    cur = key[:, 1:]
    q = pos[:, 1:] - 1
    lanes = torch.arange(n_out, dtype=i64, device=dev)
    valid = lanes[None, :] < nvalid.long()[:, None]
    prev_valid = torch.cat([(left >= 0)[:, None], valid[:, :-1]], 1)
    emit = valid & ((cur != key[:, :-1]) | ~prev_valid)

    # walk-position interval of the selected k-mer, counted from its
    # window's block offset
    scan = torch.cumsum(nd.to(i64), 1)
    blk = lanes // BLK
    before = torch.cat([torch.zeros((R, 1), dtype=i64, device=dev),
                        scan[:, BLK - 1:n_out - 1:BLK]], 1)
    base = (node_off.long() - before)[:, blk]
    s = base + scan.gather(1, q)
    e = base + scan.gather(1, q + (k - 1))
    se = ((s << 6) & UMAX32) | (e - s).clamp(max=63)

    em = emit.reshape(R, SB, BLK)
    rank = torch.cumsum(em.to(i64), 2) - 1
    cnt = em.sum(2, dtype=torch.int32)
    dst = torch.where(em & (rank < C), rank, C)

    def compact(vals, fill):
        out = torch.full((R, SB, C + 1), fill, dtype=i64, device=dev)
        out.scatter_(2, dst, vals.reshape(R, SB, BLK))
        return out[:, :, :C].reshape(R, SB * C)

    return compact(cur, DEAD_KEY), compact(se, UMAX32), cnt


_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the rows3 CUDA kernel is built from "
                       "csrc/rows3.cu on first use")


def build_rows3() -> ctypes.CDLL:
    """Build (once per source version) and load the rows3 CUDA library.
    Raises if nvcc fails; the output goes to phi_tpu_torch/_build/."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        with open(_CSRC, "rb") as f:
            src = f.read()
        tag = hashlib.sha1(src + " ".join(_NVCC_FLAGS).encode()) \
            .hexdigest()[:12]
        so = os.path.join(_BUILD_DIR, f"librows3-{tag}.so")
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc()] + _NVCC_FLAGS + ["-o", tmp, _CSRC]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.phi_rows3_launch.argtypes = [vp, vp, vp, vp, vp,
                                         ctypes.c_longlong, ci, ci, ci, ci,
                                         ci, vp, vp, vp, vp]
        lib.phi_rows3_launch.restype = ci
        _lib = lib
        return lib


def sketch_rows3(codes, nd, nvalid, left, node_off, k: int, w: int, C: int):
    """rows3 sketch: the CUDA kernel for CUDA tensors, the torch twin for
    CPU tensors (see sketch_rows3_torch for the contract). A CUDA launch
    that fails raises; `sketch_rows3.launches` counts kernel launches."""
    if codes.device.type == "cpu":
        return sketch_rows3_torch(codes, nd, nvalid, left, node_off, k, w, C)
    if codes.device.type != "cuda":
        raise ValueError(f"rows3 runs on cuda or cpu, not {codes.device}")
    _check_rows3(codes, nd, nvalid, left, node_off, k, w, C)
    lib = build_rows3()
    R = codes.shape[0]
    SB = node_off.shape[1]
    key = torch.empty((R, SB * C), dtype=torch.int64, device=codes.device)
    se = torch.empty_like(key)
    cnt = torch.empty((R, SB), dtype=torch.int32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = lib.phi_rows3_launch(
            codes.data_ptr(), nd.data_ptr(), nvalid.data_ptr(),
            left.data_ptr(), node_off.data_ptr(), codes.shape[1], R, SB, k,
            w, C, key.data_ptr(), se.data_ptr(), cnt.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"rows3 CUDA launch failed: cudaError {rc}")
    sketch_rows3.launches += 1
    return key, se, cnt


sketch_rows3.launches = 0


# ------------------------------------------------------------ the join

def flatten_hits(n_min, found, slot, se, hap_of_row, cap_total: int):
    """Row-major flattening of the hit columns (packed interval, slot, hap)
    into [cap_total] arrays; hits past cap_total are dropped (n_hit stays
    exact). Dead lanes can match empty cuckoo slots, so hits are masked to
    live intervals."""
    hit = found & (se != UMAX32)
    n_hit = hit.sum(1)
    base = torch.cumsum(n_hit, 0) - n_hit
    horder = torch.cumsum(hit.long(), 1) - 1 + base[:, None]
    hdst = torch.where(hit, horder.clamp(max=cap_total),
                       cap_total).reshape(-1)

    def flat(vals, fill):
        out = torch.full((cap_total + 1,), fill, dtype=torch.int64,
                         device=vals.device)
        out.scatter_(0, hdst, vals.reshape(-1).long())
        return out[:cap_total]

    hap_b = hap_of_row.long()[:, None].expand(se.shape)
    return n_min, n_hit, flat(se, UMAX32), flat(slot, -1), flat(hap_b, -1)


def join_rows3(words, starts, nvalid, left, base_node, hap_of_row,
               tkey, tid, seed: int, k: int, w: int, n_blocks: int, C: int,
               cap_total: int):
    """One batch of the fused sketch + join (the port of
    _pallas_join_rows3_ck): returns (n_min, n_hit, f_se, f_id, f_hap,
    cnt_max), with n_min, n_hit and cnt_max per row and the flat hit
    columns [cap_total] (-1 / UMAX32 padded)."""
    from phi_tpu_torch.ops.search import probe_cuckoo_slot
    row_lanes = (n_blocks + 1) * BLK
    codes = unpack_2bit(words, row_lanes)
    nd = delta_plane(starts, row_lanes)
    node_off = block_node_offsets(nd, base_node, n_blocks)
    key, se, cnt = sketch_rows3(codes, nd, nvalid, left, node_off, k, w, C)
    n_min = cnt.sum(1, dtype=torch.int64)
    cnt_max = cnt.amax(1)
    found, slot = probe_cuckoo_slot(tkey, seed, key)
    nm, nh, f_se, f_slot, f_hap = flatten_hits(n_min, found, slot, se,
                                               hap_of_row, cap_total)
    f_id = torch.where(f_slot >= 0, tid[f_slot.clamp(min=0)], -1)
    return nm, nh, f_se, f_id, f_hap, cnt_max
