"""The haplotype sketch and join on the device: the rows kernel family.

Five kernels, ports of the Pallas TPU kernels in `phi_tpu/sketch/kernels.py`,
are compile-time variants of one hand-written Hopper source, `csrc/rows.cu`
(built with nvcc on first use into `_build/`, loaded with ctypes):
  * `sketch_rows3` (`_make_kernel_rows3`): k <= 31, the emitted minimizers
    of each 8192-lane block left-compacted into C slots (the main path);
  * `sketch_rows3w` (`_make_kernel_rows3w`): the same for 31 < k <= 63,
    with a 126-bit key;
  * `sketch_rows2` (`_make_kernel_rows2`): k <= 31, full-lane outputs and
    an emit flag (the v2 route: spectra too large for the cuckoo table,
    and dense node chops);
  * `sketch_rows` (`_make_kernel_rows`, the v1 kernel): k <= 31, full
    lanes with the selected k-mer's row-local start instead of its walk
    interval (the hit path of `--save-index`);
  * `sketch_seq` (`_make_kernel`): `sketch_rows` on codes that may hold N;
    a k-mer holding one is dead (never selected).
On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
its plain torch twin (`sketch_rows3_torch`, ...), which computes the same
outputs over whole rows in int64.

What bounds the kernels, and their designs, are in the source note at the
top of `csrc/rows.cu`: the full-lane variants and rows3 are bound by the
bytes they move, rows3w by its 126-bit key and compare operations. Every
block is independent because the TPU kernels' grid carries (the dedup
carry, the node-count carry, the roll network compaction) become a one-base
left context, per-block node offsets and a block-wide scan. All five run
one tiled design (an O(1) key per lane from codes packed 2 bits a base,
so their codes must be 16-byte aligned; a log-doubling window minimum
computed once per lane); seq packs its N flags as a third stream of one
dead bit per base.

Around the kernels, the joins are torch ops: `join_rows3` and `join_rows3w`
port `_pallas_join_rows3_ck` and `_pallas_join_rows3w_ck` (the 2-bit
unpack, the node-start plane, the kernel, for rows3w the fold of the key to
the 64-bit join key, the cuckoo slot probe, the hit flatten and the slot ->
spectrum id remap); `join_rows2` and `join_rows2_ck` port
`_pallas_join_rows2` (mixed-bucket probe) and `_pallas_join_rows2_ck`
(cuckoo probe), with the emitted-lane compaction into [R, emitcap];
`join_rows` and `join_many` port `_pallas_join_rows` and `pallas_join_many`
(per-haplotype hit positions and spectrum ids); `sketch_sequence` and
`join_sequence` port `pallas_sketch_sequence` and `pallas_join_sequence`.

Keys are int64: a k <= 31 canonical k-mer is (hi << 32) | lo, which orders
like the reference's (hi, lo) pair; a dead lane is -1, i.e. (UMAX, UMAX).
A 31 < k <= 63 key is two int64 words, hi = w3:w2 (below 2^62) and
lo = w1:w0 (all 64 bits used, so the twin compares it with its sign bit
flipped); a dead slot is (-1, -1). Packed intervals `se` are int64 holding
the reference's u32 value ((s << 6) | min(e - s, 63)), UMAX32 on dead lanes;
positions are int32, -1 on dead lanes.
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
_DEAD_MIN = (1 << 63) - 1  # a dead k-mer inside the twin's window minimum
NARROW_MAX_K = 31   # one int64 key; 31 < k <= WIDE_MAX_K takes rows3w
WIDE_MAX_K = 63

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc", "rows.cu")
_BUILD_DIR = os.path.join(_PKG, "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_SIGN = -(1 << 63)  # int64 sign bit: x ^ _SIGN orders like x as unsigned


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


def pack_row_deltas(cumlens, rows, row_lanes: int) -> np.ndarray:
    """Dense node-start-count plane of the v2 rows (uint8 [R, row_lanes]):
    deltas[j] = number of walk_node_cumlen entries equal to start + j, with
    lane 0 forced to 0 (the row-start base's node is base_node); saturates
    at 255. The same plane as delta_plane of the row's start offsets."""
    R = len(rows)
    buf = np.zeros((R, row_lanes), np.uint8)
    for j, (si, start, nv, cont) in enumerate(rows):
        if si < 0:
            continue
        cl = cumlens[si]
        lo = np.searchsorted(cl, start, side="right")
        hi = np.searchsorted(cl, start + row_lanes)
        starts = (cl[lo:hi] - start).astype(np.int64)
        if len(starts):
            cnt = np.bincount(starts, minlength=row_lanes)[:row_lanes]
            buf[j] = np.minimum(cnt, 255).astype(np.uint8)
            buf[j, 0] = 0
    return buf


def hit_cap(w: int, super_blocks: int = SUPER_BLOCKS,
            rows_per_call: int = ROWS) -> int:
    """cap_total: the flattened hits one batch can hold (the reference's
    join_caps); a batch with more raises."""
    sup = super_blocks * BLK
    return 1 << max(15, (2 * rows_per_call * sup // (w + 1)).bit_length())


def emit_cap(w: int, super_blocks: int = SUPER_BLOCKS) -> int:
    """emitcap: the emitted lanes per row the v2 join compacts (the
    reference's join_caps, 1.3x over the ~2/(w+1) density); a row with more
    raises, and n_min stays exact."""
    return max(1024, 13 * super_blocks * BLK // (5 * (w + 1)) + 64)


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


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 lanes holding u64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _i64(c: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >> 63 else c


_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)
_GOLD = _i64(0x9E3779B97F4A7C15)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 lanes (phi_tpu.sketch.encode.mix64_np;
    int64 products wrap mod 2^64)."""
    x = x ^ _shr(x, 30)
    x = x * _MIX1
    x = x ^ _shr(x, 27)
    x = x * _MIX2
    return x ^ _shr(x, 31)


def fold128_64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """64-bit join key (as int64 bits) of a 126-bit canonical key (hi, lo):
    bit-identical to phi_tpu.sketch.encode.fold128_64_np and to the native
    read spectrum's keys for k > 31."""
    return _mix64((hi * _GOLD) ^ _mix64(lo))


# -------------------------------------------------- the kernels' twins

def _check(name, k, w, k_range, C, codes, want) -> None:
    if not k_range[0] <= k <= k_range[1]:
        raise ValueError(f"{name} needs {k_range[0]} <= k <= {k_range[1]}, "
                         f"got k={k}")
    if w < 1 or k + w - 2 > HALO_PAD:
        raise ValueError(f"{name} needs k + w - 2 <= {HALO_PAD}, got k={k} "
                         f"w={w}")
    if C is not None and not 1 <= C <= BLK:
        raise ValueError(f"{name} needs 1 <= C <= {BLK}, got C={C}")
    for arg, (t, dt, shape) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name} {arg}: want {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != codes.device:
            raise ValueError(f"{name} {arg} on {t.device}, codes on "
                             f"{codes.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} {arg} is not contiguous")


def _check_rows(name, codes, nd, nvalid, left, node_off, k, w, C,
                k_range) -> None:
    """Inputs of the interval variants (rows3, rows3w, rows2)."""
    if codes.dim() != 2 or node_off.dim() != 2:
        raise ValueError("codes [R, L] and node_off [R, SB] expected")
    R = codes.shape[0]
    SB = node_off.shape[1]
    _check(name, k, w, k_range, C, codes, {
        "codes": (codes, torch.uint8, (R, (SB + 1) * BLK)),
        "nd": (nd, torch.uint8, (R, (SB + 1) * BLK)),
        "nvalid": (nvalid, torch.int32, (R,)),
        "left": (left, torch.int32, (R,)),
        "node_off": (node_off, torch.int32, (R, SB))})


def _check_pos(name, codes, nvalid, left, k, w) -> int:
    """Inputs of the position variants (rows, seq; seq has no left).
    Returns SB, the blocks per row: codes hold SB + 1 blocks."""
    if codes.dim() != 2 or codes.shape[1] % BLK or codes.shape[1] < 2 * BLK:
        raise ValueError(f"{name} codes: want [R, (SB+1)*{BLK}] with "
                         f"SB >= 1, got {tuple(codes.shape)}")
    R, L = codes.shape
    want = {"codes": (codes, torch.uint8, (R, L)),
            "nvalid": (nvalid, torch.int32, (R,))}
    if left is not None:
        want["left"] = (left, torch.int32, (R,))
    _check(name, k, w, (1, NARROW_MAX_K), None, codes, want)
    return L // BLK - 1


def _canonical(x: torch.Tensor, k: int, nk: int, wide: bool):
    """Canonical k-mer keys at the nk lanes of x, as key columns that
    compare lexicographically with signed int64 order: [key] for k <= 31,
    [hi, lo ^ _SIGN] for the 126-bit key."""
    if not wide:
        fwd = torch.zeros((x.shape[0], nk), dtype=torch.int64,
                          device=x.device)
        rc = torch.zeros_like(fwd)
        for j in range(k):
            c = x[:, j:j + nk]
            fwd = (fwd << 2) | c
            rc |= (3 - c) << (2 * j)
        return [torch.minimum(fwd, rc)]
    fh, fl, rh, rl = (torch.zeros((x.shape[0], nk), dtype=torch.int64,
                                  device=x.device) for _ in range(4))
    for j in range(k):
        c = x[:, j:j + nk]
        if j < k - 32:           # forward: bases 0..k-33 fill the hi word
            fh = (fh << 2) | c
        else:
            fl = (fl << 2) | c
        if j < 32:               # reverse complement: base j at bit 2j
            rl |= (3 - c) << (2 * j)
        else:
            rh |= (3 - c) << (2 * j - 64)
    fl, rl = fl ^ _SIGN, rl ^ _SIGN
    f_le = (fh < rh) | ((fh == rh) & (fl <= rl))
    return [torch.where(f_le, fh, rh), torch.where(f_le, fl, rl)]


def _wmin_step(keys, pos, s):
    """Pairwise minimum of windows i and i + s over lexicographic key
    columns, ties to the right one."""
    a = [c[:, :-s] for c in keys]
    b = [c[:, s:] for c in keys]
    take_b = b[-1] <= a[-1]
    for ai, bi in zip(a[-2::-1], b[-2::-1]):
        take_b = (bi < ai) | ((bi == ai) & take_b)
    return ([torch.where(take_b, bi, ai) for ai, bi in zip(a, b)],
            torch.where(take_b, pos[:, s:], pos[:, :-s]))


def _window_minimizers(codes, nvalid, left, k: int, w: int, wide: bool,
                       ncode: bool = False):
    """Every window lane 0 .. SB*BLK-1 of the rows: (selected key columns as
    _canonical gives them, q = row-local start of the selected k-mer, emit,
    valid). With ncode, codes may hold N (>= 4): a k-mer holding one enters
    the minimum as the largest key, and a window of such k-mers is not
    valid."""
    R = codes.shape[0]
    n_out = codes.shape[1] - BLK
    dev = codes.device
    i64 = torch.int64
    # index i holds lane i - 1; lane -1 is the left base (0 when none)
    x = torch.cat([left.clamp(min=0).to(i64)[:, None], codes.to(i64)], 1)
    nk = n_out + w
    if ncode:
        bad = x > 3
        dead = torch.zeros((R, nk), dtype=torch.bool, device=dev)
        for j in range(k):
            dead |= bad[:, j:j + nk]
        x = x & 3
    keys = _canonical(x, k, nk, wide)
    if ncode:
        keys = [torch.where(dead, _DEAD_MIN, keys[0])]
    pos = torch.arange(nk, dtype=i64, device=dev).expand(R, nk)
    sdl = 1
    while sdl * 2 <= w:
        keys, pos = _wmin_step(keys, pos, sdl)
        sdl *= 2
    if w > sdl:
        keys, pos = _wmin_step(keys, pos, w - sdl)
    # windows at lanes -1 .. n_out-1
    cur = [c[:, 1:] for c in keys]
    differs = torch.zeros((R, n_out), dtype=torch.bool, device=dev)
    for c in keys:
        differs |= c[:, 1:] != c[:, :-1]
    lanes = torch.arange(n_out, dtype=i64, device=dev)
    valid = lanes[None, :] < nvalid.long()[:, None]
    prev0 = left >= 0
    if ncode:
        live = keys[0] != _DEAD_MIN
        valid &= live[:, 1:]
        prev0 = prev0 & live[:, 0]
    prev_valid = torch.cat([prev0[:, None], valid[:, :-1]], 1)
    emit = valid & (differs | ~prev_valid)
    return cur, pos[:, 1:] - 1, emit, valid


def _intervals(nd, node_off, q, k: int):
    """Packed walk-position interval of each lane's selected k-mer (q its
    row-local start), counted from its window's block offset."""
    R, n_out = q.shape
    i64 = torch.int64
    scan = torch.cumsum(nd.to(i64), 1)
    blk = torch.arange(n_out, dtype=i64, device=q.device) // BLK
    before = torch.cat([torch.zeros((R, 1), dtype=i64, device=q.device),
                        scan[:, BLK - 1:n_out - 1:BLK]], 1)
    base = (node_off.long() - before)[:, blk]
    s = base + scan.gather(1, q)
    e = base + scan.gather(1, q + (k - 1))
    return ((s << 6) & UMAX32) | (e - s).clamp(max=63)


def _lane_minimizers(codes, nd, nvalid, left, node_off, k: int, w: int,
                     wide: bool):
    """Every window lane of the interval rows: (selected key columns, packed
    interval se, emit, valid), each [R, SB*BLK]."""
    cur, q, emit, valid = _window_minimizers(codes, nvalid, left, k, w, wide)
    return cur, _intervals(nd, node_off, q, k), emit, valid


def _compact(emit, cols, SB: int, C: int):
    """Per block, the emitted lanes of each (values, fill) column
    left-compacted into C slots [R, SB*C], plus the exact counts [R, SB]."""
    R = emit.shape[0]
    em = emit.reshape(R, SB, BLK)
    rank = torch.cumsum(em.long(), 2) - 1
    dst = torch.where(em & (rank < C), rank, C)
    out = []
    for vals, fill in cols:
        o = torch.full((R, SB, C + 1), fill, dtype=torch.int64,
                       device=emit.device)
        o.scatter_(2, dst, vals.reshape(R, SB, BLK))
        out.append(o[:, :, :C].reshape(R, SB * C))
    return out, em.sum(2, dtype=torch.int32)


def sketch_rows3_torch(codes, nd, nvalid, left, node_off, k: int, w: int,
                       C: int):
    """Plain torch twin of the rows3 kernel (same inputs and outputs).

    codes, nd: uint8 [R, (SB+1)*BLK]; nvalid, left: int32 [R];
    node_off: int32 [R, SB]. Returns (key int64 [R, SB*C],
    se int64 [R, SB*C], cnt int32 [R, SB]): per block, the emitted
    minimizers left-compacted into C slots (dead past the count) and the
    exact emitted count."""
    _check_rows("rows3", codes, nd, nvalid, left, node_off, k, w, C,
                (1, NARROW_MAX_K))
    (key,), se, emit, _ = _lane_minimizers(codes, nd, nvalid, left,
                                           node_off, k, w, False)
    (key, se), cnt = _compact(emit, [(key, DEAD_KEY), (se, UMAX32)],
                              node_off.shape[1], C)
    return key, se, cnt


def sketch_rows3w_torch(codes, nd, nvalid, left, node_off, k: int, w: int,
                        C: int):
    """Plain torch twin of the rows3w kernel: rows3 for 31 < k <= 63.
    Returns (hi int64 [R, SB*C], lo int64 [R, SB*C], se int64 [R, SB*C],
    cnt int32 [R, SB]); (hi, lo) is the 126-bit canonical key, (-1, -1) on
    dead slots."""
    _check_rows("rows3w", codes, nd, nvalid, left, node_off, k, w, C,
                (NARROW_MAX_K + 1, WIDE_MAX_K))
    (hi, lo), se, emit, _ = _lane_minimizers(codes, nd, nvalid, left,
                                             node_off, k, w, True)
    (hi, lo, se), cnt = _compact(
        emit, [(hi, DEAD_KEY), (lo ^ _SIGN, DEAD_KEY), (se, UMAX32)],
        node_off.shape[1], C)
    return hi, lo, se, cnt


def sketch_rows2_torch(codes, nd, nvalid, left, node_off, k: int, w: int):
    """Plain torch twin of the rows2 kernel: every window lane, no
    compaction. Returns (key int64 [R, SB*BLK], se int64 [R, SB*BLK],
    emit bool [R, SB*BLK]); key and se are dead (-1, UMAX32) on lanes past
    nvalid."""
    _check_rows("rows2", codes, nd, nvalid, left, node_off, k, w, None,
                (1, NARROW_MAX_K))
    (key,), se, emit, valid = _lane_minimizers(codes, nd, nvalid, left,
                                               node_off, k, w, False)
    return (torch.where(valid, key, DEAD_KEY),
            torch.where(valid, se, UMAX32), emit)


def _pos_outputs(key, q, emit, valid):
    return (torch.where(valid, key, DEAD_KEY),
            torch.where(valid, q, -1).to(torch.int32), emit)


def sketch_rows_torch(codes, nvalid, left, k: int, w: int):
    """Plain torch twin of the rows (v1) kernel.

    codes: uint8 [R, (SB+1)*BLK] (2-bit codes, < 4); nvalid, left: int32
    [R]. Returns (key int64, pos int32, emit bool), each [R, SB*BLK]: every
    window lane's minimizer, the row-local start of its k-mer and whether
    the lane emits; key and pos are dead (-1) on lanes past nvalid."""
    _check_pos("rows", codes, nvalid, left, k, w)
    (key,), q, emit, valid = _window_minimizers(codes, nvalid, left, k, w,
                                                False)
    return _pos_outputs(key, q, emit, valid)


def sketch_seq_torch(codes, nvalid, k: int, w: int):
    """Plain torch twin of the single-sequence kernel: the rows twin on
    codes that may hold N (>= 4), with no left base. A k-mer holding N is
    never selected; a window of such k-mers is not valid (dead key and
    pos -1, no emit), and the next valid window emits."""
    _check_pos("seq", codes, nvalid, None, k, w)
    left = torch.full((codes.shape[0],), -1, dtype=torch.int32,
                      device=codes.device)
    (key,), q, emit, valid = _window_minimizers(codes, nvalid, left, k, w,
                                                False, ncode=True)
    return _pos_outputs(key, q, emit, valid)


# ------------------------------------------------ the kernels on the card

_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the rows CUDA kernels are built from "
                       "csrc/rows.cu on first use")


def _library_path() -> str:
    with open(_CSRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha1(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"librows-{tag}.so")


def build_rows() -> ctypes.CDLL:
    """Build (once per source version) and load the rows kernel library.
    Raises if nvcc fails; the output goes to phi_tpu_torch/_build/, with
    ptxas's report of each kernel beside it (build_log)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = _library_path()
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc()] + _NVCC_FLAGS + ["-o", tmp, _CSRC]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            with open(f"{so}.log", "w") as f:
                f.write(proc.stderr)
            os.replace(tmp, so)
        _lib = _bind(ctypes.CDLL(so))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the library's entry points."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    inputs = [vp, vp, vp, vp, vp, cl, ci, ci, ci, ci]
    wide = inputs + [ci, vp, vp, vp, vp, vp]
    full = inputs + [vp, vp, vp, vp]
    pos_inputs = [vp, vp, vp, cl, ci, ci, ci, ci]
    narrow = inputs + [ci, vp, vp, vp, vp]
    pos = pos_inputs + [vp, vp, vp, vp]
    for name, args in (("rows3", narrow), ("rows3w", wide), ("rows2", full),
                       ("rows", pos), ("seq", pos)):
        fn = getattr(lib, f"phi_{name}_launch")
        fn.argtypes = args
        fn.restype = ci
    lib.phi_rows_occupancy.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ci)]
    lib.phi_rows_occupancy.restype = ci
    return lib


def build_log() -> str:
    """nvcc's -Xptxas -v report of the built library (registers, shared
    memory and spills of every kernel instantiation)."""
    build_rows()
    with open(f"{_library_path()}.log") as f:
        return f.read()


def occupancy(name: str) -> int:
    """Resident blocks per SM of the kernel behind `phi_{name}_launch` on
    the current device (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks = ctypes.c_int(0)
    rc = build_rows().phi_rows_occupancy(name.encode(), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"{name} occupancy query failed: {rc}")
    return blocks.value


def _launch(name: str, ins: tuple, SB: int, k: int, w: int, extra: tuple,
            outs: tuple, lib: ctypes.CDLL | None = None) -> None:
    """Launch the kernel `phi_{name}_launch` of lib (default: build_rows())
    on the current stream of the first input's device: the input tensors
    (None for a null pointer), then row_lanes, R, SB, k, w, the extra ints,
    the outputs and the stream. Raises if the launch fails."""
    codes = ins[0]
    fn = getattr(lib or build_rows(), f"phi_{name}_launch")
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = fn(*(None if t is None else t.data_ptr() for t in ins),
                codes.shape[1], codes.shape[0], SB, k, w, *extra,
                *(t.data_ptr() for t in outs), stream)
    if rc != 0:
        raise RuntimeError(f"{name} CUDA launch failed: cudaError {rc}")


def _on_card(name: str, codes) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the twin); any other device raises."""
    if codes.device.type == "cpu":
        return False
    if codes.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {codes.device}")
    return True


def _check_aligned(entry: str, codes) -> None:
    """The tiled kernels pack each row's codes from 16-byte loads."""
    if codes.data_ptr() % 16:
        raise ValueError(f"{entry} needs codes aligned to 16 bytes")


def sketch_rows3(codes, nd, nvalid, left, node_off, k: int, w: int, C: int):
    """rows3 sketch: the CUDA kernel for CUDA tensors, the torch twin for
    CPU tensors (see sketch_rows3_torch for the contract). A CUDA launch
    that fails raises; `sketch_rows3.launches` counts kernel launches."""
    if not _on_card("rows3", codes):
        return sketch_rows3_torch(codes, nd, nvalid, left, node_off, k, w, C)
    _check_rows("rows3", codes, nd, nvalid, left, node_off, k, w, C,
                (1, NARROW_MAX_K))
    _check_aligned("rows3", codes)
    R, SB = node_off.shape
    key = torch.empty((R, SB * C), dtype=torch.int64, device=codes.device)
    se = torch.empty_like(key)
    cnt = torch.empty((R, SB), dtype=torch.int32, device=codes.device)
    _launch("rows3", (codes, nd, nvalid, left, node_off), SB, k, w, (C,),
            (key, se, cnt))
    sketch_rows3.launches += 1
    return key, se, cnt


def sketch_rows3w(codes, nd, nvalid, left, node_off, k: int, w: int,
                  C: int):
    """rows3w sketch (31 < k <= 63): the CUDA kernel for CUDA tensors, the
    torch twin for CPU tensors (see sketch_rows3w_torch);
    `sketch_rows3w.launches` counts kernel launches."""
    if not _on_card("rows3w", codes):
        return sketch_rows3w_torch(codes, nd, nvalid, left, node_off, k, w,
                                   C)
    _check_rows("rows3w", codes, nd, nvalid, left, node_off, k, w, C,
                (NARROW_MAX_K + 1, WIDE_MAX_K))
    _check_aligned("rows3w", codes)
    R, SB = node_off.shape
    hi = torch.empty((R, SB * C), dtype=torch.int64, device=codes.device)
    lo = torch.empty_like(hi)
    se = torch.empty_like(hi)
    cnt = torch.empty((R, SB), dtype=torch.int32, device=codes.device)
    _launch("rows3w", (codes, nd, nvalid, left, node_off), SB, k, w, (C,),
            (hi, lo, se, cnt))
    sketch_rows3w.launches += 1
    return hi, lo, se, cnt


def sketch_rows2(codes, nd, nvalid, left, node_off, k: int, w: int):
    """rows2 sketch (full lanes): the CUDA kernel for CUDA tensors, the
    torch twin for CPU tensors (see sketch_rows2_torch);
    `sketch_rows2.launches` counts kernel launches."""
    if not _on_card("rows2", codes):
        return sketch_rows2_torch(codes, nd, nvalid, left, node_off, k, w)
    _check_rows("rows2", codes, nd, nvalid, left, node_off, k, w, None,
                (1, NARROW_MAX_K))
    _check_aligned("rows2", codes)
    R, SB = node_off.shape
    key = torch.empty((R, SB * BLK), dtype=torch.int64, device=codes.device)
    se = torch.empty_like(key)
    emit = torch.empty((R, SB * BLK), dtype=torch.bool, device=codes.device)
    _launch("rows2", (codes, nd, nvalid, left, node_off), SB, k, w, (),
            (key, se, emit))
    sketch_rows2.launches += 1
    return key, se, emit


def _launch_pos(name: str, codes, nvalid, left, k: int, w: int):
    """Check, then launch a position variant (rows, seq) into fresh
    full-lane outputs."""
    SB = _check_pos(name, codes, nvalid, left, k, w)
    _check_aligned(name, codes)
    R = codes.shape[0]
    key = torch.empty((R, SB * BLK), dtype=torch.int64, device=codes.device)
    pos = torch.empty((R, SB * BLK), dtype=torch.int32, device=codes.device)
    emit = torch.empty((R, SB * BLK), dtype=torch.bool, device=codes.device)
    _launch(name, (codes, nvalid, left), SB, k, w, (), (key, pos, emit))
    return key, pos, emit


def sketch_rows(codes, nvalid, left, k: int, w: int):
    """rows (v1) sketch: the CUDA kernel for CUDA tensors, the torch twin
    for CPU tensors (see sketch_rows_torch); `sketch_rows.launches` counts
    kernel launches."""
    if not _on_card("rows", codes):
        return sketch_rows_torch(codes, nvalid, left, k, w)
    out = _launch_pos("rows", codes, nvalid, left, k, w)
    sketch_rows.launches += 1
    return out


def sketch_seq(codes, nvalid, k: int, w: int):
    """Single-sequence sketch (codes may hold N): the CUDA kernel for CUDA
    tensors, the torch twin for CPU tensors (see sketch_seq_torch);
    `sketch_seq.launches` counts kernel launches."""
    if not _on_card("seq", codes):
        return sketch_seq_torch(codes, nvalid, k, w)
    out = _launch_pos("seq", codes, nvalid, None, k, w)
    sketch_seq.launches += 1
    return out


sketch_rows3.launches = 0
sketch_rows3w.launches = 0
sketch_rows2.launches = 0
sketch_rows.launches = 0
sketch_seq.launches = 0


# ------------------------------------------------------------ the joins

def _flatten(hit, cols, cap_total: int):
    """Row-major flattening of the hit lanes of each (values, fill) column
    into [cap_total] arrays; hits past cap_total are dropped. Returns
    (n_hit [R], the flat columns)."""
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

    return n_hit, [flat(vals, fill) for vals, fill in cols]


def flatten_hits(n_min, found, idx, se, hap_of_row, cap_total: int):
    """Row-major flattening of the hit columns (packed interval, idx, hap)
    into [cap_total] arrays; idx is a table slot or a spectrum id. Hits past
    cap_total are dropped (n_hit stays exact). Dead lanes can match empty
    cuckoo slots, so hits are masked to live intervals."""
    hap_b = hap_of_row.long()[:, None].expand(se.shape)
    n_hit, (f_se, f_idx, f_hap) = _flatten(
        found & (se != UMAX32), [(se, UMAX32), (idx, -1), (hap_b, -1)],
        cap_total)
    return n_min, n_hit, f_se, f_idx, f_hap


def _kernel_inputs(words, nd, base_node, n_blocks: int):
    """(codes, node_off) of a packed batch with node-start plane nd."""
    codes = unpack_2bit(words, (n_blocks + 1) * BLK)
    return codes, block_node_offsets(nd, base_node, n_blocks)


def _join_compacted(key, se, cnt, hap_of_row, tkey, tid, seed: int,
                    cap_total: int):
    """The v3 joins' tail: cuckoo slot probe of the compacted keys, hit
    flatten, slot -> spectrum id. Returns (n_min, n_hit, f_se, f_id, f_hap,
    cnt_max)."""
    from phi_tpu_torch.ops.search import probe_cuckoo_slot
    n_min = cnt.sum(1, dtype=torch.int64)
    found, slot = probe_cuckoo_slot(tkey, seed, key)
    nm, nh, f_se, f_slot, f_hap = flatten_hits(n_min, found, slot, se,
                                               hap_of_row, cap_total)
    f_id = torch.where(f_slot >= 0, tid[f_slot.clamp(min=0)], -1)
    return nm, nh, f_se, f_id, f_hap, cnt.amax(1)


def join_rows3(words, starts, nvalid, left, base_node, hap_of_row,
               tkey, tid, seed: int, k: int, w: int, n_blocks: int, C: int,
               cap_total: int):
    """One batch of the fused sketch + join (the port of
    _pallas_join_rows3_ck): returns (n_min, n_hit, f_se, f_id, f_hap,
    cnt_max), with n_min, n_hit and cnt_max per row and the flat hit
    columns [cap_total] (-1 / UMAX32 padded)."""
    nd = delta_plane(starts, (n_blocks + 1) * BLK)
    codes, node_off = _kernel_inputs(words, nd, base_node, n_blocks)
    key, se, cnt = sketch_rows3(codes, nd, nvalid, left, node_off, k, w, C)
    return _join_compacted(key, se, cnt, hap_of_row, tkey, tid, seed,
                           cap_total)


def join_rows3w(words, starts, nvalid, left, base_node, hap_of_row,
                tkey, tid, seed: int, k: int, w: int, n_blocks: int, C: int,
                cap_total: int):
    """join_rows3 for 31 < k <= 63 (the port of _pallas_join_rows3w_ck):
    the rows3w keys fold to the 64-bit join key of the read spectrum before
    the probe. The fold of a dead slot is a fixed value that can equal a
    table key; flatten_hits masks dead slots by their interval."""
    nd = delta_plane(starts, (n_blocks + 1) * BLK)
    codes, node_off = _kernel_inputs(words, nd, base_node, n_blocks)
    hi, lo, se, cnt = sketch_rows3w(codes, nd, nvalid, left, node_off, k, w,
                                    C)
    return _join_compacted(fold128_64(hi, lo), se, cnt, hap_of_row, tkey,
                           tid, seed, cap_total)


def compact_emitted(emit, key, se, emitcap: int, se_fill: int = UMAX32):
    """Each row's emitted lanes, in lane order, into [R, emitcap] columns
    (key, passenger), dead-padded (-1, se_fill); the passenger is the
    packed interval (v2) or the k-mer position (v1, se_fill -1). Lanes past
    emitcap are dropped."""
    order = torch.cumsum(emit.long(), 1) - 1
    dst = torch.where(emit, order.clamp(max=emitcap), emitcap)

    def gather(vals, fill):
        out = torch.full((emit.shape[0], emitcap + 1), fill,
                         dtype=torch.int64, device=emit.device)
        return out.scatter_(1, dst, vals)[:, :emitcap]

    return gather(key, DEAD_KEY), gather(se.long(), se_fill)


def _join_lanes(words, deltas, nvalid, left, base_node, k: int, w: int,
                n_blocks: int, emitcap: int):
    """The v2 joins' head: rows2 over the dense node plane, then the
    emitted-lane compaction. Returns (n_min, key, se), the last two
    [R, emitcap]."""
    codes, node_off = _kernel_inputs(words, deltas, base_node, n_blocks)
    key, se, emit = sketch_rows2(codes, deltas, nvalid, left, node_off, k, w)
    return (emit.sum(1),) + compact_emitted(emit, key, se, emitcap)


def join_rows2(words, deltas, nvalid, left, base_node, hap_of_row, table,
               k: int, w: int, n_blocks: int, emitcap: int, cap_total: int):
    """One v2 batch with the mixed-bucket probe (the port of
    _pallas_join_rows2): deltas is the dense node plane (pack_row_deltas),
    table the (m, lo, perm, off, rounds, bits) of
    ops.search.mixed_tensors. Returns (n_min, n_hit, f_se, f_id, f_hap)."""
    from phi_tpu_torch.ops.search import pair_isin_mixed
    n_min, key, se = _join_lanes(words, deltas, nvalid, left, base_node, k,
                                 w, n_blocks, emitcap)
    m, lo, perm, off, rounds, bits = table
    found, ids = pair_isin_mixed(m, lo, perm, off, key, rounds, bits)
    return flatten_hits(n_min, found, ids, se, hap_of_row, cap_total)


def join_rows2_ck(words, deltas, nvalid, left, base_node, hap_of_row, tkey,
                  tid, seed: int, k: int, w: int, n_blocks: int,
                  emitcap: int, cap_total: int):
    """One v2 batch with the id-returning cuckoo probe (the port of
    _pallas_join_rows2_ck, taken for a dense node chop). Returns (n_min,
    n_hit, f_se, f_id, f_hap)."""
    from phi_tpu_torch.ops.search import probe_cuckoo_slot
    n_min, key, se = _join_lanes(words, deltas, nvalid, left, base_node, k,
                                 w, n_blocks, emitcap)
    found, slot = probe_cuckoo_slot(tkey, seed, key)
    ids = torch.where(found, tid[slot.clamp(min=0)], -1)
    return flatten_hits(n_min, found & (ids >= 0), ids, se, hap_of_row,
                        cap_total)


def join_rows(words, nvalid, left, table, k: int, w: int, n_blocks: int,
              emitcap: int, cap_total: int):
    """One v1 batch (the port of _pallas_join_rows): the 2-bit unpack, the
    rows kernel, the emitted-lane compaction, the mixed-bucket probe (table
    as ops.search.mixed_tensors gives it) and the flatten of the hits'
    (row-local k-mer start, spectrum id). Returns (n_min, n_hit, f_pos,
    f_id): counts per row and flat [cap_total] columns, -1 padded. n_min is
    exact; emitted lanes past emitcap and hits past cap_total are dropped
    (the caller reruns with larger caps)."""
    from phi_tpu_torch.ops.search import pair_isin_mixed
    codes = unpack_2bit(words, (n_blocks + 1) * BLK)
    key, pos, emit = sketch_rows(codes, nvalid, left, k, w)
    ekey, epos = compact_emitted(emit, key, pos, emitcap, -1)
    m, lo, perm, off, rounds, bits = table
    found, ids = pair_isin_mixed(m, lo, perm, off, ekey, rounds, bits)
    n_hit, (f_pos, f_id) = _flatten(found & (epos >= 0),
                                    [(epos, -1), (ids, -1)], cap_total)
    return emit.sum(1), n_hit, f_pos, f_id


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _empty_hits() -> tuple[int, np.ndarray, np.ndarray]:
    return 0, np.zeros(0, np.int32), np.zeros(0, np.int32)


def plan_join_rows(seqs: list[np.ndarray], k: int, w: int,
                   super_blocks: int = SUPER_BLOCKS):
    """The v1 join's rows: (results, rows). results holds the empty hits of
    each sequence shorter than one window and None elsewhere; rows are the
    (si, start, n_windows, cont) of the other A/C/G/T sequences, at most
    super_blocks * BLK windows each. A sequence holding N gets no rows (its
    result stays None: the caller's host join)."""
    halo = k + w - 2
    sup = super_blocks * BLK
    results: list = [None] * len(seqs)
    rows: list[tuple[int, int, int, int]] = []
    for i, codes in enumerate(seqs):
        L = len(codes)
        if L < w + k - 1:
            results[i] = _empty_hits()
            continue
        if (codes >= 4).any():
            continue
        for start in range(0, max(1, L - halo), sup):
            rows.append((i, start, min(sup, L - halo - start),
                         1 if start else 0))
    return results, rows


def pack_join_host(seqs, batch, row_lanes: int, pin: bool = False):
    """One v1 batch as host tensors: (words int32 view [R, row_lanes //
    16], nvalid int32 [R], left int32 [R]), page-locked when `pin`."""
    out = (torch.from_numpy(pack_rows_2bit(seqs, batch, row_lanes)
                            .view(np.int32)),
           torch.tensor([r[2] for r in batch], dtype=torch.int32),
           torch.from_numpy(pack_row_left(seqs, batch)))
    return tuple(t.pin_memory() for t in out) if pin else out


def pack_join_batch(seqs, batch, row_lanes: int, device):
    """One v1 batch on the device (pack_join_host's tensors)."""
    from phi_tpu_torch import state
    return state.upload(pack_join_host(seqs, batch, row_lanes), device)


# v1 batches in flight: a batch's counts are read (and an overflowing
# batch rerun) once WINDOW later batches are queued behind it
WINDOW = 3

# A graph's packed join batches, kept in its memo (graph.pangenome) under
# BATCHES as (params, batches, row plan or None): their device tensors are
# a pure function of the graph's walks and params (k, w, rows,
# super-blocks, route, S_cap, device), so a later join on the held graph
# with the same params neither plans, packs nor uploads. One entry a
# graph, shared by the two anchor routes: a join with other params drops
# it before it packs, and keeps its own where their bytes are at most
# pangenome.BATCHES_MAX_BYTES.
BATCHES = ("batches",)
# hit-path joins since the process started: served from the graph's
# batches, packed and kept, or packed and not kept (over the limit, or a
# mesh)
HITS_SLOT_STATS = {"hits": 0, "stores": 0, "misses": 0}


def held_batches(memo: dict, params: tuple):
    """(batches, plan) of the memo's entry where it was packed with
    `params`, else None."""
    entry = memo.get(BATCHES)
    return entry[1:] if entry is not None and entry[0] == params else None


def batches_bytes(memo: dict) -> int:
    """Device bytes of the packed batches a graph's memo keeps."""
    entry = memo.get(BATCHES)
    return 0 if entry is None else sum(t.nbytes for tens in entry[1]
                                       for t in tens)


def join_many(seqs: list[np.ndarray], k: int, w: int, sp_hi, sp_lo, *,
              device, devices=None, rows_per_call: int | None = None,
              super_blocks: int | None = None, memo: dict | None = None):
    """Sketch + join of many sequences against the read spectrum (the port
    of pallas_join_many): per sequence, (n_minimizers, hit positions int32,
    hit spectrum ids int32), hits in position order. A sequence holding N
    comes back None (the caller's host join), one shorter than a window
    empty.

    Each sequence is cut into rows of super_blocks * BLK windows
    (plan_join_rows), batched rows_per_call at a time. A row that continues
    a sequence takes the base at start - 1 as its left context
    (pack_row_left), so rows and batches carry nothing. The geometry
    defaults to ROWS rows of SUPER_BLOCKS blocks, read when called.

    A worker thread packs batch b + 1 while batch b is uploaded and
    launched; WINDOW batches are in flight, and a batch's counts are read
    once WINDOW later batches are queued. A batch whose emitted lanes
    overflow emitcap or whose hits overflow cap_total (the reference's
    join_caps) is rerun there with the caps raised to the next power of
    two; n_min is exact either way, and since batches carry nothing the
    rerun touches no other batch. Spans (trace.py): plan, cuckoo and join
    (its batches' pack_wait, dispatch and harvest).

    `memo` is the memo of the graph whose walks the sequences are. With
    it, a join on one device keeps its row plan and uploaded batches there
    (BATCHES) under (k, w), the geometry, the route "hits" and the device:
    on a hit they come from the memo, so plan and pack_wait read ~0 and
    nothing is packed or uploaded; on a miss the join drops the entry,
    packs and uploads as without it, and keeps its plan and batches where
    their bytes fit pangenome.BATCHES_MAX_BYTES. The sample's part (the
    spectrum table, every batch's join, reruns, the harvest) runs either
    way. HITS_SLOT_STATS counts each join given a memo.

    With `devices` (a mesh's devices, which may repeat), the sequences are
    round-robined over them, sequence j on devices[j % len(devices)], each
    device joining against its own copy of the spectrum table; the
    results come back in sequence order, the same as with devices None."""
    if devices is not None and len(devices) > 1:
        results: list = [None] * len(seqs)
        for j, d in enumerate(devices):
            idx = list(range(j, len(seqs), len(devices)))
            outs = join_many([seqs[i] for i in idx], k, w, sp_hi, sp_lo,
                             device=d, rows_per_call=rows_per_call,
                             super_blocks=super_blocks) if idx else []
            for i, out in zip(idx, outs):
                results[i] = out
        return results
    if not 1 <= k <= NARROW_MAX_K:
        raise ValueError(f"join_many needs 1 <= k <= {NARROW_MAX_K}, "
                         f"got k={k}")
    if k + w - 2 > HALO_PAD:
        raise ValueError(f"k + w - 2 must be <= {HALO_PAD}")
    from concurrent.futures import ThreadPoolExecutor

    from phi_tpu_torch import state
    from phi_tpu_torch.graph import pangenome
    from phi_tpu_torch.ops.search import mixed_tensors
    from phi_tpu_torch.trace import span
    device = torch.device(device)
    super_blocks = super_blocks or SUPER_BLOCKS
    row_lanes = (super_blocks + 1) * BLK
    R = rows_per_call or ROWS
    params = (k, w, R, super_blocks, "hits", None, str(device))
    with span("plan"):
        held = None if memo is None else held_batches(memo, params)
        plan = held[1] if held is not None else \
            plan_join_rows(seqs, k, w, super_blocks)
    results, rows = list(plan[0]), plan[1]
    if not rows:
        return results
    n_batches = -(-len(rows) // R)
    # the list this join's batches go into when the memo is to keep them
    keep = None
    if memo is not None:
        fits = n_batches * R * (row_lanes // 4 + 8) \
            <= pangenome.BATCHES_MAX_BYTES
        if held is not None and fits:
            HITS_SLOT_STATS["hits"] += 1
        else:
            held = None
            memo.pop(BATCHES, None)
            keep = [] if fits else None
            if not fits:
                HITS_SLOT_STATS["misses"] += 1
    with span("cuckoo"):
        table = mixed_tensors(sp_hi, sp_lo, device)
    caps = (emit_cap(w, super_blocks), hit_cap(w, super_blocks, R))
    padded = rows + [(-1, 0, 0, 0)] * (n_batches * R - len(rows))
    pin = device.type == "cuda"

    def pack(b):
        return pack_join_host(seqs, padded[b * R:(b + 1) * R], row_lanes,
                              pin)

    def dispatch(tens, emitcap, cap_total):
        out = join_rows(*tens, table, k, w, super_blocks, emitcap, cap_total)
        return out, state.fetch(torch.stack(out[:2]))

    # per batch: [inputs, (n_min, n_hit, f_pos, f_id), counts' fetch], then
    # at its harvest (counts, fetch of the hit prefix)
    pend: list = [None] * n_batches
    done: list = [None] * n_batches

    def harvest(b):
        with span("harvest"):
            tens, out, cfetch = pend[b]
            nm, nh = state.fetched(cfetch)
            emitcap, cap_total = caps
            while nm.max() > emitcap or nh.sum() > cap_total:
                emitcap = _next_pow2(max(emitcap, nm.max()))
                cap_total = _next_pow2(max(cap_total, nh.sum()))
                out, cfetch = dispatch(tens, emitcap, cap_total)
                nm, nh = state.fetched(cfetch)
            tot = int(nh.sum())
            pend[b] = None
            done[b] = (nm, nh, state.fetch(out[2][:tot]),
                       state.fetch(out[3][:tot]))

    with span("join"):
        packer = ThreadPoolExecutor(1) if held is None else None
        try:
            if packer is not None:
                fut = packer.submit(pack, 0)
            for b in range(n_batches):
                with span("pack_wait"):
                    got = held[0][b] if held is not None else fut.result()
                if packer is not None and b + 1 < n_batches:
                    fut = packer.submit(pack, b + 1)
                with span("dispatch"):
                    if held is None:
                        got = state.upload(got, device)
                        if keep is not None:
                            keep.append(got)
                    pend[b] = [got, *dispatch(got, *caps)]
                if b >= WINDOW:
                    harvest(b - WINDOW)
            for b in range(max(0, n_batches - WINDOW), n_batches):
                harvest(b)
        finally:
            if packer is not None:
                packer.shutdown(wait=False, cancel_futures=True)
        if keep is not None:
            memo[BATCHES] = (params, keep, plan)
            HITS_SLOT_STATS["stores"] += 1
        acc: dict[int, tuple[int, list, list]] = {}
        with span("harvest"):
            for b in range(n_batches):
                nm, nh, pfetch, ifetch = done[b]
                fpos, fid = state.fetched(pfetch), state.fetched(ifetch)
                off = 0
                for j, (si, start, _, _) in enumerate(
                        padded[b * R:(b + 1) * R]):
                    if si < 0:
                        continue
                    n_acc, pos_parts, id_parts = acc.get(si, (0, [], []))
                    pos_parts.append(fpos[off:off + nh[j]] + start)
                    id_parts.append(fid[off:off + nh[j]])
                    acc[si] = (n_acc + int(nm[j]), pos_parts, id_parts)
                    off += nh[j]
    for si, (n_min, pos_parts, id_parts) in acc.items():
        results[si] = (n_min, np.concatenate(pos_parts).astype(np.int32),
                       np.concatenate(id_parts).astype(np.int32))
    return results


def _seq_tensors(codes: np.ndarray, k: int, w: int, device):
    """One sequence as the single-sequence kernel takes it: codes uint8
    [1, (nb+1)*BLK], padded with N (4), in a fresh allocation (so aligned
    to 16 bytes, as the kernel's packing loads need), and nvalid int32
    [1]."""
    L = len(codes)
    n_valid = L - k - w + 2
    need = (max(1, -(-n_valid // BLK)) + 1) * BLK
    buf = torch.full((1, need), 4, dtype=torch.uint8, device=device)
    n = min(L, need)
    buf[0, :n] = torch.from_numpy(np.ascontiguousarray(codes[:n]))
    return (buf, torch.tensor([n_valid], dtype=torch.int32, device=device))


def _seq_minimizers(codes: np.ndarray, k: int, w: int, device):
    """(key int64, pos int32) of the emitted windows of one sequence, on
    the device, or None when it is shorter than one window."""
    if not 1 <= k <= NARROW_MAX_K:
        raise ValueError(f"the single-sequence kernel needs 1 <= k <= "
                         f"{NARROW_MAX_K}, got k={k}")
    if len(codes) < w + k - 1:
        return None
    key, pos, emit = sketch_seq(*_seq_tensors(codes, k, w, device), k, w)
    return key[emit], pos[emit]


def sketch_sequence(codes: np.ndarray, k: int, w: int, *, device):
    """(hi uint32, lo uint32, pos int32) minimizers of one sequence that
    may hold N (the port of pallas_sketch_sequence): the emitted windows
    with consecutive equal keys removed, as the reference's caller does."""
    out = _seq_minimizers(codes, k, w, device)
    if out is None:
        z = np.zeros(0, np.uint32)
        return z, z.copy(), np.zeros(0, np.int32)
    key, pos = (t.cpu().numpy() for t in out)
    if len(key) > 1:
        keep = np.ones(len(key), bool)
        keep[1:] = key[1:] != key[:-1]
        key, pos = key[keep], pos[keep]
    return ((key >> 32).astype(np.uint32),
            (key & UMAX32).astype(np.uint32), pos.astype(np.int32))


def join_sequence(codes: np.ndarray, k: int, w: int, sp_hi, sp_lo, *,
                  device):
    """(n_minimizers, hit positions int32, hit spectrum ids int32) of one
    sequence that may hold N against the sorted read spectrum (the port of
    pallas_join_sequence): the single-sequence kernel, the emitted lanes
    (sized by their exact count) and a sorted-key binary search."""
    from phi_tpu_torch import state
    from phi_tpu_torch.ops.search import pair_isin
    out = _seq_minimizers(codes, k, w, device)
    if out is None:
        return _empty_hits()
    key, pos = out
    found, idx = pair_isin(state.spectrum_keys(sp_hi, sp_lo, device), key)
    hit = found & (pos >= 0)
    return (len(key), pos[hit].cpu().numpy().astype(np.int32),
            idx[hit].cpu().numpy().astype(np.int32))
