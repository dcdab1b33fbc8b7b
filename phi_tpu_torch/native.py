"""ctypes bindings for the native host library (`native/phi_native.cpp` at
the repo root), the port's copy of `phi_tpu/native.py` cut to the calls the
port makes: GFA and read ingest, toposort, the walk-code concatenation, the
lane CSR, the read spectrum, the anchor tables of the hit path and the edit
distance.

The library is built on first use with `make -C native` (g++ and zlib).
Unlike the JAX package, the port keeps no pure-Python fallbacks: without
the library each call returns None (the pipeline then raises) or raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native")
_SO = os.path.join(_DIR, "libphi_native.so")
_lib: ctypes.CDLL | None = None
_tried = False
_lib_lock = threading.Lock()

c_p = ctypes.c_void_p
c_i64 = ctypes.c_int64
c_i32p = ctypes.POINTER(ctypes.c_int32)
c_i64p = ctypes.POINTER(ctypes.c_int64)
c_u8p = ctypes.POINTER(ctypes.c_uint8)
c_char_p = ctypes.c_char_p


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _DIR, "-s"], check=True,
                       capture_output=True, timeout=300)
        return os.path.exists(_SO)
    except Exception:
        return False


def get_lib() -> ctypes.CDLL | None:
    if _lib is not None:  # lock-free fast path only once fully initialized
        return _lib
    with _lib_lock:
        return _get_lib_locked()


def _get_lib_locked() -> ctypes.CDLL | None:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    if not os.path.exists(_SO) and not _build():
        _tried = True
        return None
    lib = ctypes.CDLL(_SO)
    lib.phi_gfa_parse.restype = c_p
    lib.phi_gfa_parse.argtypes = [c_char_p]
    lib.phi_gfa_error.restype = c_char_p
    lib.phi_gfa_error.argtypes = [c_p]
    for name in ("phi_gfa_n_vtx", "phi_gfa_n_edges", "phi_gfa_n_walks",
                 "phi_gfa_seq_len", "phi_gfa_walk_total"):
        getattr(lib, name).restype = c_i64
        getattr(lib, name).argtypes = [c_p]
    lib.phi_gfa_node_len.restype = c_i64p
    lib.phi_gfa_node_off.restype = c_i64p
    lib.phi_gfa_seq_code.restype = c_u8p
    lib.phi_gfa_edge_u.restype = c_i32p
    lib.phi_gfa_edge_v.restype = c_i32p
    lib.phi_gfa_walk_concat.restype = c_i32p
    lib.phi_gfa_walk_off.restype = c_i64p
    for name in ("phi_gfa_node_len", "phi_gfa_node_off", "phi_gfa_seq_code",
                 "phi_gfa_edge_u", "phi_gfa_edge_v", "phi_gfa_walk_concat",
                 "phi_gfa_walk_off"):
        getattr(lib, name).argtypes = [c_p]
    for name in ("phi_gfa_seg_names", "phi_gfa_walk_names",
                 "phi_gfa_seg_tags", "phi_gfa_walk_meta"):
        getattr(lib, name).restype = c_p
        getattr(lib, name).argtypes = [c_p, c_i64p]
    lib.phi_gfa_free.argtypes = [c_p]

    lib.phi_reads_load.restype = c_p
    lib.phi_reads_load.argtypes = [c_char_p]
    lib.phi_reads_error.restype = c_char_p
    lib.phi_reads_error.argtypes = [c_p]
    lib.phi_reads_count.restype = c_i64
    lib.phi_reads_count.argtypes = [c_p]
    lib.phi_reads_total.restype = c_i64
    lib.phi_reads_total.argtypes = [c_p]
    lib.phi_reads_codes.restype = c_u8p
    lib.phi_reads_codes.argtypes = [c_p]
    lib.phi_reads_off.restype = c_i64p
    lib.phi_reads_off.argtypes = [c_p]
    lib.phi_reads_names.restype = c_p
    lib.phi_reads_names.argtypes = [c_p, c_i64p]
    lib.phi_reads_free.argtypes = [c_p]

    lib.phi_toposort.restype = ctypes.c_int
    lib.phi_toposort.argtypes = [c_i64, c_i64, c_i32p, c_i32p, c_i32p]

    lib.phi_edit_distance.restype = c_i64
    lib.phi_edit_distance.argtypes = [c_u8p, c_i64, c_u8p, c_i64, c_i64]

    lib.phi_set_threads.restype = None
    lib.phi_set_threads.argtypes = [ctypes.c_int]

    lib.phi_spectrum.restype = c_i64
    lib.phi_spectrum.argtypes = [c_u8p, c_i64p, c_i64, ctypes.c_int,
                                 ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_uint64), c_i64]

    lib.phi_minimizers.restype = c_i64
    lib.phi_minimizers.argtypes = [c_u8p, c_i64, ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_uint32),
                                   ctypes.POINTER(ctypes.c_uint32), c_i32p,
                                   c_i64]

    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.phi_hap_join.restype = c_i64
    lib.phi_hap_join.argtypes = [c_u8p, c_i64, ctypes.c_int, ctypes.c_int,
                                 u64p, c_i64, c_i64p, ctypes.c_int,
                                 c_i32p, c_i32p, c_i64, c_i64p]
    lib.phi_hap_join_walk.restype = c_i64
    lib.phi_hap_join_walk.argtypes = [c_u8p, c_i64p, c_i32p, c_i64,
                                      ctypes.c_int, ctypes.c_int, u64p,
                                      c_i64, c_i64p, ctypes.c_int,
                                      c_i32p, c_i32p, c_i64, c_i64p]

    lib.phi_anchors.restype = c_p
    lib.phi_anchors.argtypes = [c_i64, c_i64, c_i32p, c_i32p, c_i64p,
                                c_i64p, ctypes.POINTER(c_i32p),
                                ctypes.POINTER(c_i32p), c_i64,
                                ctypes.c_int32, ctypes.c_double]
    for name in ("phi_anchors_n_occ", "phi_anchors_n_model_kmers",
                 "phi_anchors_filtered_kmers"):
        getattr(lib, name).restype = c_i64
        getattr(lib, name).argtypes = [c_p]
    for name in ("phi_anchors_occ_hap", "phi_anchors_occ_start",
                 "phi_anchors_occ_end", "phi_anchors_occ_kmer"):
        getattr(lib, name).restype = c_i32p
        getattr(lib, name).argtypes = [c_p]
    lib.phi_anchors_per_hap.restype = c_i64p
    lib.phi_anchors_per_hap.argtypes = [c_p]
    lib.phi_anchors_free.argtypes = [c_p]

    lib.phi_lane_csr.restype = None
    lib.phi_lane_csr.argtypes = [c_i64, c_i64, c_i32p, c_i32p, c_i64,
                                 c_i64p, c_i64p]
    lib.phi_walk_codes.restype = c_i64
    lib.phi_walk_codes.argtypes = [c_u8p, c_i64p, c_i32p, c_i64, c_u8p]
    _lib = lib
    _tried = True
    return _lib


_NO_LIB = ("the native library is unavailable "
           "(make -C native needs g++ and zlib)")


def _need_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(_NO_LIB)
    return lib


def available() -> bool:
    return get_lib() is not None


# the thread count asked for (0 = auto): the native pools get it through
# phi_set_threads, the Python pools (the host join across haplotypes) read
# it here
THREADS = 0


def set_threads(n: int) -> None:
    """Set every native and host pool's size (the CLI's -t; 0 = auto)."""
    global THREADS
    THREADS = max(0, int(n))
    _need_lib().phi_set_threads(THREADS)


def pool_threads(default_cap: int = 8) -> int:
    """Host pool size for the Python thread fan-outs."""
    if THREADS > 0:
        return THREADS
    return min(default_cap, os.cpu_count() or 1)


_HUGE = 2 << 20  # x86-64 huge page
_MADV_HUGEPAGE = 14


def advise_hugepage(*arrays) -> None:
    """madvise(MADV_HUGEPAGE) the 2MB-aligned interior of large numpy
    buffers: allocations past the malloc mmap threshold come as fresh
    4 KiB-faulting mmaps, and huge pages cut the fault count 512x.
    Best-effort no-op on failure or small arrays; PHI_TPU_NO_HUGEPAGE=1
    disables the advice."""
    if os.environ.get("PHI_TPU_NO_HUGEPAGE") == "1":
        return
    try:
        libc = ctypes.CDLL(None, use_errno=True)
    except Exception:
        return
    for a in arrays:
        if a is None or a.nbytes < (8 << 20):
            continue
        addr = a.ctypes.data
        start = (addr + _HUGE - 1) & ~(_HUGE - 1)
        end = (addr + a.nbytes) & ~(_HUGE - 1)
        if end > start:
            try:
                libc.madvise(ctypes.c_void_p(start),
                             ctypes.c_size_t(end - start), _MADV_HUGEPAGE)
            except Exception:
                return


def _copy(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def _strings(lib_fn, h) -> list[str]:
    ln = c_i64(0)
    p = lib_fn(h, ctypes.byref(ln))
    return ctypes.string_at(p, ln.value).decode().split("\0")[:-1] \
        if ln.value else []


def parse_gfa_native(path: str):
    """Returns GfaData via the native parser, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.phi_gfa_parse(path.encode())
    try:
        err = lib.phi_gfa_error(h)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        n = lib.phi_gfa_n_vtx(h)
        m = lib.phi_gfa_n_edges(h)
        nw = lib.phi_gfa_n_walks(h)
        slen = lib.phi_gfa_seq_len(h)
        wtot = lib.phi_gfa_walk_total(h)
        node_len = _copy(lib.phi_gfa_node_len(h), n, np.int64)
        node_off = _copy(lib.phi_gfa_node_off(h), n + 1, np.int64)
        seq_code = _copy(lib.phi_gfa_seq_code(h), slen, np.uint8)
        edge_u = _copy(lib.phi_gfa_edge_u(h), m, np.int32)
        edge_v = _copy(lib.phi_gfa_edge_v(h), m, np.int32)
        wconcat = _copy(lib.phi_gfa_walk_concat(h), wtot, np.int32)
        woff = _copy(lib.phi_gfa_walk_off(h), nw + 1, np.int64)
        seg_names = _strings(lib.phi_gfa_seg_names, h)
        walk_names = _strings(lib.phi_gfa_walk_names, h)
        seg_tags = _strings(lib.phi_gfa_seg_tags, h)
        meta_raw = _strings(lib.phi_gfa_walk_meta, h)
    finally:
        lib.phi_gfa_free(h)
    from phi_tpu_torch.io.gfa import GfaData

    def _meta(s: str) -> tuple[str, int, int]:
        parts = s.split("\t")
        try:
            return parts[0], int(parts[1]), int(parts[2])
        except (IndexError, ValueError):
            return (parts[0] if parts else "_"), 0, 0
    walk_meta = [_meta(s) for s in meta_raw]
    # views into the single wconcat copy: per-walk copies would double the
    # walk concat at chromosome scale
    walks = [wconcat[woff[i]:woff[i + 1]] for i in range(nw)]
    return GfaData(seg_names=seg_names, node_len=node_len, node_off=node_off,
                   seq_code=seq_code, edge_u=edge_u, edge_v=edge_v,
                   walks=walks, walk_names=walk_names,
                   seg_tags=seg_tags, walk_meta=walk_meta)


def load_reads_native(path: str):
    """Returns (codes_concat, offsets, names) or None."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.phi_reads_load(path.encode())
    try:
        err = lib.phi_reads_error(h)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        n = lib.phi_reads_count(h)
        tot = lib.phi_reads_total(h)
        codes = _copy(lib.phi_reads_codes(h), tot, np.uint8)
        off = _copy(lib.phi_reads_off(h), n + 1, np.int64)
        names = _strings(lib.phi_reads_names, h)
    finally:
        lib.phi_reads_free(h)
    return codes, off, names


def toposort_native(n_vtx: int, edge_u: np.ndarray, edge_v: np.ndarray):
    """Topological order (int32 [n_vtx]); raises on a cycle."""
    lib = _need_lib()
    order = np.zeros(n_vtx, np.int32)
    eu = np.ascontiguousarray(edge_u, np.int32)
    ev = np.ascontiguousarray(edge_v, np.int32)
    rc = lib.phi_toposort(
        n_vtx, len(eu),
        eu.ctypes.data_as(c_i32p), ev.ctypes.data_as(c_i32p),
        order.ctypes.data_as(c_i32p))
    if rc != 0:
        raise ValueError("graph has a cycle: topological order impossible "
                         "(PHI requires an acyclic graph)")
    return order


def spectrum_native(concat: np.ndarray, off: np.ndarray, k: int, w: int
                    ) -> np.ndarray | None:
    """Emitted canonical minimizer keys (uint64, duplicates included) of a
    ragged read concatenation, each read scanned independently. None if the
    library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    cc = np.ascontiguousarray(concat, np.uint8)
    oo = np.ascontiguousarray(off, np.int64)
    n_reads = len(oo) - 1
    cap = max(1024, 4 * len(cc) // (w + 1) + 64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    while True:
        out = np.empty(cap, np.uint64)
        cnt = lib.phi_spectrum(cc.ctypes.data_as(c_u8p),
                               oo.ctypes.data_as(c_i64p), n_reads, k, w,
                               out.ctypes.data_as(u64p), cap)
        if cnt < 0:
            return None
        if cnt <= cap:
            return out[:cnt].copy()
        cap = int(cnt)


def minimizers_native(codes: np.ndarray, k: int, w: int):
    """(hi uint32, lo uint32, pos int32) minimizers of one sequence by the
    native scan, the only one for 31 < k <= 63 (hi/lo then halve the
    folded 64-bit key). Raises if the library is missing."""
    lib = _need_lib()
    cc = np.ascontiguousarray(codes, np.uint8)
    n = len(cc)
    cap = max(1024, 4 * n // (w + 1) + 64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    while True:
        hi = np.empty(cap, np.uint32)
        lo = np.empty(cap, np.uint32)
        pos = np.empty(cap, np.int32)
        cnt = lib.phi_minimizers(cc.ctypes.data_as(c_u8p), n, k, w,
                                 hi.ctypes.data_as(u32p),
                                 lo.ctypes.data_as(u32p),
                                 pos.ctypes.data_as(c_i32p), cap)
        if cnt <= cap:
            return hi[:cnt].copy(), lo[:cnt].copy(), pos[:cnt].copy()
        cap = int(cnt)


def join_accel(sp_key: np.ndarray) -> tuple[np.ndarray, int]:
    """(bucket_off, prefix_bits) first-probe table over sorted uint64 keys:
    bucket_off[b] is the first index whose top prefix_bits equal b. Built
    once per spectrum and shared by the haplotypes' joins."""
    n = len(sp_key)
    # ~1 key per bucket: the table is about the size of the keys
    prefix_bits = max(1, min(26, int(np.log2(max(n, 2)))))
    edges = (np.arange((1 << prefix_bits) + 1, dtype=np.uint64)
             << np.uint64(64 - prefix_bits))
    edges[-1] = np.uint64(0xFFFFFFFFFFFFFFFF)
    off = np.searchsorted(sp_key, edges, side="left").astype(np.int64)
    off[-1] = n  # the top edge takes the all-ones key
    return off, prefix_bits


def _hap_join(call, n_bases: int, w: int, sp_key: np.ndarray, accel):
    """Run one native join call(keys, n_keys, bucket_off, prefix_bits, pos,
    sid, cap, n_min), retrying with the returned hit count as the cap.
    Returns (n_minimizers, hit positions int32, hit spectrum ids int32)."""
    kk = np.ascontiguousarray(sp_key, np.uint64)
    cap = max(1024, 4 * n_bases // (w + 1) + 64)
    n_min = c_i64(0)
    if accel is not None:
        off_arr = np.ascontiguousarray(accel[0], np.int64)
        off_ptr, prefix_bits = off_arr.ctypes.data_as(c_i64p), accel[1]
    else:
        off_ptr, prefix_bits = None, 0
    while True:
        pos = np.empty(cap, np.int32)
        sid = np.empty(cap, np.int32)
        cnt = call(kk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                   len(kk), off_ptr, prefix_bits, pos.ctypes.data_as(c_i32p),
                   sid.ctypes.data_as(c_i32p), cap, ctypes.byref(n_min))
        if cnt < 0:
            raise RuntimeError("the native host join failed")
        if cnt <= cap:
            return int(n_min.value), pos[:cnt].copy(), sid[:cnt].copy()
        cap = int(cnt)


def hap_join_native(codes: np.ndarray, k: int, w: int, sp_key: np.ndarray,
                    accel: tuple[np.ndarray, int] | None = None
                    ) -> tuple[int, np.ndarray, np.ndarray]:
    """(n_minimizers, hit positions int32, hit spectrum ids int32) of one
    sequence (codes >= 4 are N) joined against sorted uint64 spectrum keys;
    for k > 31 the keys are the 64-bit folds of the 126-bit k-mers. The
    scan releases the GIL, so callers thread across haplotypes; a shared
    join_accel(sp_key) replaces each emission's full binary search by a
    first-probe lookup."""
    lib = _need_lib()
    cc = np.ascontiguousarray(codes, np.uint8)
    return _hap_join(
        lambda *rest: lib.phi_hap_join(cc.ctypes.data_as(c_u8p), len(cc), k,
                                       w, *rest),
        len(cc), w, sp_key, accel)


def hap_join_walk_native(seq_code: np.ndarray, node_off: np.ndarray,
                         walk: np.ndarray, walk_bases: int, k: int, w: int,
                         sp_key: np.ndarray,
                         accel: tuple[np.ndarray, int] | None = None
                         ) -> tuple[int, np.ndarray, np.ndarray]:
    """hap_join_native on a walk read node by node from the graph tensors
    (no concatenated copy); walk_bases sizes the first hit capacity."""
    lib = _need_lib()
    sc = np.ascontiguousarray(seq_code, np.uint8)
    no = np.ascontiguousarray(node_off, np.int64)
    wk = np.ascontiguousarray(walk, np.int32)
    return _hap_join(
        lambda *rest: lib.phi_hap_join_walk(
            sc.ctypes.data_as(c_u8p), no.ctypes.data_as(c_i64p),
            wk.ctypes.data_as(c_i32p), len(wk), k, w, *rest),
        walk_bases, w, sp_key, accel)


def anchors_native(graph, k: int,
                   hits: list[tuple[int, np.ndarray, np.ndarray]],
                   spectrum_size: int, threshold: float):
    """Native anchor-table construction: returns (occ_hap, occ_start,
    occ_end, occ_kmer, n_model_kmers, filtered_kmers, per_hap_anchors), or
    None when the library is missing or a haplotype's hit positions are not
    ascending (the native pass 1 checks). Hits are handed over as per-hap
    pointers, with no concatenation."""
    lib = get_lib()
    if lib is None:
        return None
    H = graph.num_walks
    hit_cnt = np.zeros(max(H, 1), np.int64)
    # per-hap contiguous int32 views, kept alive across the call
    pos_arrs, sid_arrs = [], []
    for h in range(H):
        hit_cnt[h] = len(hits[h][1])
        pos_arrs.append(np.ascontiguousarray(hits[h][1], np.int32))
        sid_arrs.append(np.ascontiguousarray(hits[h][2], np.int32))
    empty = np.zeros(1, np.int32)
    pos_ptrs = (c_i32p * max(H, 1))(*[
        (a if len(a) else empty).ctypes.data_as(c_i32p) for a in pos_arrs
    ] or [empty.ctypes.data_as(c_i32p)])
    sid_ptrs = (c_i32p * max(H, 1))(*[
        (a if len(a) else empty).ctypes.data_as(c_i32p) for a in sid_arrs
    ] or [empty.ctypes.data_as(c_i32p)])
    wm = np.ascontiguousarray(graph.walk_mat, np.int32)
    wl = np.ascontiguousarray(graph.walk_len, np.int32)
    nl = np.ascontiguousarray(graph.gfa.node_len, np.int64)
    hp = lib.phi_anchors(
        H, graph.walk_mat.shape[1] if H else 0,
        wm.ctypes.data_as(c_i32p), wl.ctypes.data_as(c_i32p),
        nl.ctypes.data_as(c_i64p),
        hit_cnt.ctypes.data_as(c_i64p), pos_ptrs, sid_ptrs,
        spectrum_size, k, threshold)
    if not hp:
        return None
    try:
        n_occ = lib.phi_anchors_n_occ(hp)
        occ_hap = _copy(lib.phi_anchors_occ_hap(hp), n_occ, np.int32)
        occ_start = _copy(lib.phi_anchors_occ_start(hp), n_occ, np.int32)
        occ_end = _copy(lib.phi_anchors_occ_end(hp), n_occ, np.int32)
        occ_kmer = _copy(lib.phi_anchors_occ_kmer(hp), n_occ, np.int32)
        n_model = int(lib.phi_anchors_n_model_kmers(hp))
        filtered = int(lib.phi_anchors_filtered_kmers(hp))
        per_hap = _copy(lib.phi_anchors_per_hap(hp), H, np.int64)
    finally:
        lib.phi_anchors_free(hp)
    return occ_hap, occ_start, occ_end, occ_kmer, n_model, filtered, per_hap


def lane_csr_native(walk_mat: np.ndarray, walk_len: np.ndarray,
                    n_vtx: int):
    """(off, values) of the vertex -> flat-lane-state CSR."""
    lib = _need_lib()
    H, P = walk_mat.shape
    wm = np.ascontiguousarray(walk_mat, np.int32)
    wl = np.ascontiguousarray(walk_len, np.int32)
    total = int(wl.sum())
    off = np.zeros(n_vtx + 1, np.int64)
    values = np.empty(total, np.int64)
    advise_hugepage(values)
    lib.phi_lane_csr(H, P, wm.ctypes.data_as(c_i32p),
                     wl.ctypes.data_as(c_i32p), n_vtx,
                     off.ctypes.data_as(c_i64p),
                     values.ctypes.data_as(c_i64p))
    return off, values


def walk_codes_native(seq_code: np.ndarray, node_off: np.ndarray,
                      walk: np.ndarray) -> np.ndarray:
    """Concatenated base codes of one walk."""
    lib = _need_lib()
    sc = np.ascontiguousarray(seq_code, np.uint8)
    no = np.ascontiguousarray(node_off, np.int64)
    wk = np.ascontiguousarray(walk, np.int32)
    total = int((no[wk + 1] - no[wk]).sum())
    out = np.empty(total, np.uint8)
    n = lib.phi_walk_codes(sc.ctypes.data_as(c_u8p),
                           no.ctypes.data_as(c_i64p),
                           wk.ctypes.data_as(c_i32p), len(wk),
                           out.ctypes.data_as(c_u8p))
    return out[:n]


def edit_distance(a: np.ndarray | str, b: np.ndarray | str,
                  k_limit: int = -1) -> int:
    """Banded Myers bit-parallel edit distance."""
    from phi_tpu_torch.io.gfa import encode_seq
    if isinstance(a, str):
        a = encode_seq(a)
    if isinstance(b, str):
        b = encode_seq(b)
    lib = _need_lib()
    aa = np.ascontiguousarray(a, np.uint8)
    bb = np.ascontiguousarray(b, np.uint8)
    return int(lib.phi_edit_distance(
        aa.ctypes.data_as(c_u8p), len(aa),
        bb.ctypes.data_as(c_u8p), len(bb), k_limit))
