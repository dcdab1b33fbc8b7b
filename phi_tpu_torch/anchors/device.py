"""Device anchor pipeline: fused sketch + join batches into a device hit
buffer, then the reference's threshold filter on the device.

The port of `phi_tpu/anchors/device.py`:
  1. each batch of rows runs one of the joins of `sketch.kernels`, chosen
     under the reference's conditions:
       - v3 (`join_rows3`, the rows3 kernel and the cuckoo slot probe) when
         the read spectrum fits the cuckoo table and the node chop is not
         denser than one start per 4 bases; `join_rows3w` (the rows3w
         kernel) for 31 < k <= 63;
       - v2 cuckoo (`join_rows2_ck`, the rows2 kernel) for a dense chop;
       - v2 mixed (`join_rows2`, the rows2 kernel and the mixed-bucket
         probe) when the spectrum does not fit the cuckoo table;
     and is appended to the hit buffers at a device-side offset (no host
     sync per batch);
  2. the filter groups occurrences by (k-mer, vertex-run identity) through
     a 2x32-bit polynomial prefix hash over the walks, resolves single-run
     k-mers by a min == max uniformity test, and counts the remaining
     ambiguous groups with the ownership-table loop; it reads the hits in
     chunks of PHI_TPU_FIN_CHUNK (2^26) hits, so its temporaries stay a
     chunk's size at chromosome scale (one chunk below it);
  3. the retained multi-vertex occurrences stay on the device for the
     solver (DeviceOcc) and are copied to the host for decode.

Where the reference leaves the device anchors (N in a walk, more than 255
haplotypes, k + w - 2 beyond the kernels' halo, k > 31 with a spectrum too
large for the cuckoo table or a dense node chop, no walk as long as a
window, an emit, hit or compaction overflow, unresolved ownership),
join_anchors_device returns None, as the reference does, and says why on
stderr; the pipeline then takes the host hit path. It also returns None
where a k-mer may span more than 63 walk positions (a chain of empty
nodes): the kernels pack a span in 6 bits, clamped at 63, which the
reference's device route has too (a known fault of the reference) and
the host hit path does not. Any other failure, of a kernel's build or
launch among them, raises. The 32-bit hashes run in int64 lanes masked to
32 bits.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from phi_tpu_torch.graph import pangenome
from phi_tpu_torch.graph.pangenome import (PangenomeGraph, max_kmer_span,
                                          memoized)
from phi_tpu_torch import state
from phi_tpu_torch.ops.search import make_cuckoo, mixed_tensors, mul32
from phi_tpu_torch.sketch.kernels import (BATCHES, BLK, HALO_PAD,
                                          NARROW_MAX_K, ROWS, SUPER_BLOCKS,
                                          batches_bytes, block_cap, emit_cap,
                                          held_batches, hit_cap, join_rows2,
                                          join_rows2_ck, join_rows3,
                                          join_rows3w, pack_row_deltas,
                                          pack_row_left, pack_rows_2bit,
                                          row_base_nodes)
from phi_tpu_torch.trace import span

_M32 = 0xFFFFFFFF
# independent odd multipliers for the two polynomial prefix-hash moduli
_POLY1 = 0x9E3779B1
_POLY2 = 0x85EBCA77
_MAX_SPAN = 64            # pw table size; packed spans are <= 63
MAX_HAPS = 255            # the reference's u8 hap column; more take the hit path
_OWNER_ROUNDS = 16        # ownership-loop cap (expected ~3-4 rounds)
# hits per pass of the threshold filter: each pass holds a handful of
# chunk-length int64 columns (eval.hbm_budget), ~4 GB at 2^26
FIN_CHUNK = 1 << 26
# batches in flight: batch b's counts are read once batch b + WINDOW is
# queued, so the host never waits on the batch the card is running
WINDOW = 3

# the packed batches in the graph's memo (sketch.kernels.BATCHES): hits,
# stores and drops of the device anchors since the process started
PACK_CACHE_STATS = {"hits": 0, "stores": 0, "drops": 0}
# inferences by anchors route since the process started: a device route
# (DeviceOcc.route) or "hits", the host hit path (pipeline.py counts them)
ANCHOR_ROUTE_STATS = {"v3": 0, "v3w": 0, "v2ck": 0, "v2mixed": 0, "hits": 0}


def _fallback(msg: str) -> None:
    """Say on stderr why the device anchors hand over to the host hit
    path (the caller then returns None)."""
    sys.stderr.write(f"[W::anchors] device path fallback: {msg}; host hit "
                     f"path\n")
    sys.stderr.flush()


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64 lanes holding u32 values."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def build_ph(walk_mat: torch.Tensor, poly: int) -> torch.Tensor:
    """Per-lane vertex prefix hashes PH[h, p] (int64 [H, P+1], u32 values)
    of walk_mat[h, :p] under x -> x*poly + (v+1) mod 2^32, PH[:, 0] = 0.
    A log-step (Hillis-Steele) scan of the affine maps (m, a): the combine
    (ml, al) . (mr, ar) = (ml*mr, al*mr + ar) is associative mod 2^32, so
    the result is exact."""
    H, P = walk_mat.shape
    a = (walk_mat + 1) & _M32
    m = torch.full_like(a, poly)
    s = 1
    while s < P:
        a_new = a.clone()
        m_new = m.clone()
        a_new[:, s:] = (mul32(a[:, :-s], m[:, s:]) + a[:, s:]) & _M32
        m_new[:, s:] = mul32(m[:, :-s], m[:, s:])
        a, m = a_new, m_new
        s *= 2
    return torch.cat([torch.zeros((H, 1), dtype=a.dtype, device=a.device),
                      a], 1)


def pw_tables() -> tuple[np.ndarray, np.ndarray]:
    pw1 = np.ones(_MAX_SPAN + 2, np.int64)
    pw2 = np.ones(_MAX_SPAN + 2, np.int64)
    for i in range(1, _MAX_SPAN + 2):
        pw1[i] = (int(pw1[i - 1]) * _POLY1) & _M32
        pw2[i] = (int(pw2[i - 1]) * _POLY2) & _M32
    return pw1, pw2


def _bucket_size(n: int, minimum: int) -> int:
    """Smallest {2^k, 3*2^(k-1)} >= n (64k multiples above 2^20): sizes the
    ownership table exactly as the reference does."""
    n = max(n, 1)
    if n <= minimum:
        return minimum
    if n > (1 << 20):
        return -(-n // (1 << 16)) * (1 << 16)
    p = minimum
    while True:
        if n <= p:
            return p
        if n <= p + p // 2:
            return p + p // 2
        p *= 2


@dataclasses.dataclass
class DeviceOcc:
    """Retained multi-vertex occurrences on the device, in (hap, position)
    order, plus the filter's stats."""
    dev_s: torch.Tensor      # int64 [n_occ] walk-position starts
    dev_span: torch.Tensor   # int64 [n_occ] end - start
    dev_id: torch.Tensor     # int64 [n_occ] spectrum ids
    dev_hap: torch.Tensor    # int64 [n_occ]
    dev_w: torch.Tensor      # float32 [n_occ] weights (1.0)
    n_occ: int
    n_model: int
    filtered: int
    per_hap_anchors: np.ndarray
    max_span: int = 0        # max end - start among retained occurrences
    n_hits: int = 0          # join hits the filter read (all routes)
    n_chunks: int = 1        # passes of fin_chunk() hits the filter took
    n_amb: int = 0           # occurrences of ambiguous k-mers
    owner_rounds: int = 0    # rounds of the ownership loop
    pack_bytes: int = 0      # device bytes of this run's batches the graph keeps
    route: str = ""          # the kernel route: v3, v3w, v2ck or v2mixed

    def materialize(self):
        """(occ_hap, occ_start, occ_end, occ_kmer) int32 host arrays."""
        s = self.dev_s.cpu().numpy().astype(np.int32)
        span = self.dev_span.cpu().numpy().astype(np.int32)
        kid = self.dev_id.cpu().numpy().astype(np.int32)
        hap = self.dev_hap.cpu().numpy().astype(np.int32)
        return hap, s, s + span, kid


def pack_row_starts(cumlens, rows, row_lanes: int, S_cap: int) -> np.ndarray:
    """Per-row sorted node-start offsets (int32 [R, S_cap], padded with
    row_lanes). Offsets are >= 1: a node boundary at the row start belongs
    to the row's base node."""
    R = len(rows)
    buf = np.full((R, S_cap), row_lanes, np.int32)
    for j, (si, start, nv, cont) in enumerate(rows):
        if si < 0:
            continue
        cl = cumlens[si]
        lo = np.searchsorted(cl, start, side="right")
        hi = np.searchsorted(cl, start + row_lanes)
        buf[j, :hi - lo] = (cl[lo:hi] - start).astype(np.int32)
    return buf


def _row_start_cap(cumlens, rows, row_lanes: int) -> int:
    """Max node-start count over the rows, as a power of two (>= 1024):
    the reference's width, so its dense-chop test gives the same answer."""
    mx = 1
    for (si, start, nv, cont) in rows:
        if si < 0:
            continue
        cl = cumlens[si]
        n = (np.searchsorted(cl, start + row_lanes)
             - np.searchsorted(cl, start, side="right"))
        mx = max(mx, int(n))
    return 1 << max(10, int(mx - 1).bit_length())


def plan_rows(seqs: list[np.ndarray], k: int, w: int,
              super_blocks: int = SUPER_BLOCKS):
    """Split every walk into rows (si, start, n_windows, cont) of at most
    super_blocks * BLK windows. Walks shorter than one window are
    skipped. None when a walk holds N (code >= 4): the 2-bit rows cannot
    carry it."""
    halo = k + w - 2
    sup = super_blocks * BLK
    rows: list[tuple[int, int, int, int]] = []
    for i, codes in enumerate(seqs):
        L = len(codes)
        if L < w + k - 1:
            continue
        if (codes >= 4).any():
            _fallback(f"walk {i} contains non-ACGT bases")
            return None
        for start in range(0, max(1, L - halo), sup):
            rows.append((i, start, min(sup, L - halo - start),
                         1 if start else 0))
    return rows


def pack_batch(seqs, cumlens, batch, row_lanes: int, S_cap: int | None):
    """Host numpy arrays of one batch: (words uint32, nodes, nvalid, left,
    base_node, hap), the last four int32. nodes holds the node-start
    offsets (int32 [R, S_cap]) of the v3 routes, or with S_cap None the
    dense node plane (uint8 [R, row_lanes]) of the v2 routes."""
    nodes = pack_row_deltas(cumlens, batch, row_lanes) if S_cap is None \
        else pack_row_starts(cumlens, batch, row_lanes, S_cap)
    return (pack_rows_2bit(seqs, batch, row_lanes), nodes,
            np.array([r[2] for r in batch], np.int32),
            pack_row_left(seqs, batch),
            row_base_nodes(cumlens, batch),
            np.array([max(r[0], 0) for r in batch], np.int32))


def pack_cache_bytes() -> int:
    """Device bytes of the packed batches the held panel keeps (either
    route's)."""
    graph = pangenome.held_graph()
    return 0 if graph is None else batches_bytes(graph.memo)


def hit_buffer_len(windows: int, w: int, super_blocks: int = SUPER_BLOCKS,
                   rows_per_call: int = ROWS) -> int:
    """CAP, the hit buffers' length: the expected minimizers of `windows`
    windows with headroom (~2.6/(w+1) a window), plus one batch's hits so
    that a clamped append never overwrites live hits before the overflow
    check."""
    return int(windows * 2.6 / (w + 1)) + hit_cap(w, super_blocks,
                                                 rows_per_call)


def join_anchors_device(graph: PangenomeGraph, seqs: list[np.ndarray],
                        k: int, w: int, sp_hi, sp_lo, threshold: float,
                        *, device, rows_per_call: int | None = None,
                        super_blocks: int | None = None):
    """Fused sketch + join + anchor filter over all haplotypes on `device`.
    seqs are the graph's walk sequences (graph.walk_seq_codes). Returns
    (per_hap_minimizers int64 [H], DeviceOcc), or None where the reference
    leaves the device path (module docstring); the caller then takes the
    host hit path.

    PHI_TPU_PACK_WORKERS (3) threads pack the host batches that many
    ahead of the one being launched, into page-locked memory; the calling
    thread uploads, launches and appends them in batch order, so the
    result is the same for any worker count, and reads each batch's
    counts WINDOW batches later. A worker's exception is raised here. The
    packed batches are kept on the device in the graph's memo for a later
    run on the same graph (sketch.kernels.BATCHES). Spans (trace.py):
    plan, cuckoo, join (its batches' pack_wait, dispatch and harvest),
    walk_hashes and filter."""
    device = torch.device(device)
    R = rows_per_call or ROWS
    SB = super_blocks or SUPER_BLOCKS
    H = graph.num_walks
    if H > MAX_HAPS:
        _fallback(f"{H} haplotypes > {MAX_HAPS} (u8 hap column)")
        return None
    if k + w - 2 > HALO_PAD:
        _fallback(f"k + w - 2 = {k + w - 2} > {HALO_PAD} (the kernels' "
                  f"halo)")
        return None
    with span("plan"):
        span_k = max_kmer_span(graph, k)
    if span_k > _MAX_SPAN - 1:
        # the packed interval clamps its span to 63; the host hit path's
        # are exact (without empty nodes a span is at most k - 1 <= 62)
        _fallback(f"k-mers may span {span_k} > {_MAX_SPAN - 1}: spans past "
                  f"{_MAX_SPAN - 1} walk positions (zero-length node chains)")
        return None
    if int(graph.walk_len.max(initial=0)) >= 1 << 26:
        raise ValueError("a walk has >= 2^26 positions: the packed "
                         "(s << 6) | span interval overflows 32 bits")
    row_lanes = (SB + 1) * BLK
    with span("plan"):
        rows = plan_rows(seqs, k, w, SB)
    if not rows:  # N walks, or no walk as long as one window
        return None
    cumlens = graph.walk_node_cumlen
    # the reference's route choice: v3 needs the cuckoo table and a node
    # chop of at most one start per 4 bases; k > 31 runs only on v3
    with span("cuckoo"):
        ck = make_cuckoo(np.asarray(sp_hi), np.asarray(sp_lo))
    with span("plan"):
        S_cap = _row_start_cap(cumlens, rows, row_lanes) \
            if ck is not None else None
    dense = S_cap is not None and S_cap * 4 > row_lanes
    wide = k > NARROW_MAX_K
    if wide and (ck is None or dense):
        why = (f"a read spectrum of {len(sp_hi)} keys that does not fit the "
               f"cuckoo table" if ck is None else
               "a dense node chop (more than one node start per 4 bases)")
        _fallback(f"k={k} > {NARROW_MAX_K} with {why}")
        return None
    use_v3 = ck is not None and not dense
    if not use_v3:
        S_cap = None  # v2 uploads the dense node plane
    route = ("v3w" if wide else "v3") if use_v3 else \
        ("v2ck" if ck is not None else "v2mixed")
    C = block_cap(w)
    emitcap = emit_cap(w, SB)
    cap_total = hit_cap(w, SB, R)
    CAP = hit_buffer_len(sum(r[2] for r in rows), w, SB, R)
    n_batches = -(-len(rows) // R)
    padded = rows + [(-1, 0, 0, 0)] * (n_batches * R - len(rows))

    with span("cuckoo"):
        if ck is not None:
            tkey, tid, seed = state.cuckoo_tensors(ck, device)
        else:
            table = mixed_tensors(sp_hi, sp_lo, device)

    # the graph's packed batches: a hit where its memo holds them for this
    # join's parameters and the reference's estimate of their bytes fits
    # the limit; else the entry is dropped before this run allocates, and
    # the run keeps its own batches where they fit
    fits = n_batches * R * (row_lanes // 4 + (S_cap * 4 if use_v3
                                              else row_lanes)) \
        <= pangenome.BATCHES_MAX_BYTES
    params = (k, w, R, SB, route, S_cap, str(device))
    held = held_batches(graph.memo, params) if fits else None
    if held is not None:
        cached, keep = held[0], None
        PACK_CACHE_STATS["hits"] += 1
    else:
        cached, keep = None, [] if fits else None
        if graph.memo.pop(BATCHES, None) is not None:
            PACK_CACHE_STATS["drops"] += 1

    def join(tens):
        """(n_min, n_hit, f_se, f_id, f_hap, over): over is the per-row
        count held against its cap, the largest block count (v3, cap C) or
        the emitted lanes (v2, cap emitcap)."""
        if use_v3:
            return (join_rows3w if wide else join_rows3)(
                *tens, tkey, tid, seed, k, w, SB, C, cap_total)
        if ck is None:
            out = join_rows2(*tens, table, k, w, SB, emitcap, cap_total)
        else:
            out = join_rows2_ck(*tens, tkey, tid, seed, k, w, SB, emitcap,
                                cap_total)
        return out + (out[0],)

    pin = device.type == "cuda"

    def pack(b):
        batch = padded[b * R:(b + 1) * R]
        return state.host_batch(
            *pack_batch(seqs, cumlens, batch, row_lanes, S_cap), pin=pin)

    counts = np.zeros((n_batches, 3, R), np.int64)
    pend: list = [None] * n_batches

    def harvest(b):
        with span("harvest"):
            counts[b] = state.fetched(pend[b])
        pend[b] = None

    with span("join"):
        buf_se = torch.zeros(CAP, dtype=torch.int64, device=device)
        buf_id = torch.full((CAP,), -1, dtype=torch.int64, device=device)
        buf_hap = torch.zeros(CAP, dtype=torch.int64, device=device)
        total = torch.zeros((), dtype=torch.int64, device=device)
        lane = torch.arange(cap_total, device=device)
        ahead = max(1, int(os.environ.get("PHI_TPU_PACK_WORKERS", "3")))
        pool = ThreadPoolExecutor(ahead) if cached is None else None
        futs: dict = {}
        try:
            if pool is not None:
                for b0 in range(min(ahead, n_batches)):
                    futs[b0] = pool.submit(pack, b0)
            for b in range(n_batches):
                if cached is None:
                    with span("pack_wait"):
                        host = futs.pop(b).result()
                    if b + ahead < n_batches:
                        futs[b + ahead] = pool.submit(pack, b + ahead)
                with span("dispatch"):
                    if cached is None:
                        tens = state.upload(host, device)
                        del host
                        if keep is not None:
                            keep.append(tens)
                    else:
                        tens = cached[b]
                    nm, nh, f_se, f_id, f_hap, over = join(tens)
                    del tens
                    # append at the device-side offset; an overflow clamps
                    # (and is caught below) instead of writing out of bounds
                    idx = total.clamp(max=CAP - cap_total) + lane
                    buf_se.index_copy_(0, idx, f_se)
                    buf_id.index_copy_(0, idx, f_id)
                    buf_hap.index_copy_(0, idx, f_hap.clamp(min=0))
                    total += (f_id >= 0).sum()
                    pend[b] = state.fetch(torch.stack([nm, nh, over.long()]))
                if b >= WINDOW:
                    harvest(b - WINDOW)
            for b in range(max(0, n_batches - WINDOW), n_batches):
                harvest(b)
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
        if keep is not None:
            graph.memo[BATCHES] = (params, keep, None)
            PACK_CACHE_STATS["stores"] += 1
        pack_bytes = batches_bytes(graph.memo) if fits else 0

        total_hits = int(counts[:, 1].sum())
        if total_hits > CAP - cap_total:
            _fallback(f"hit buffer overflow ({total_hits} hits > "
                      f"{CAP - cap_total})")
            return None
        over_cap = C if use_v3 else emitcap
        if counts[:, 2].max(initial=0) > over_cap:
            what = "rows3 block compaction" if use_v3 else "v2 emitted-lane"
            _fallback(f"{what} overflow (max {int(counts[:, 2].max())} > "
                      f"{'C' if use_v3 else 'emitcap'}={over_cap})")
            return None
        per_hap_min = np.zeros(H, np.int64)
        for b in range(n_batches):
            if int(counts[b, 1].sum()) > cap_total:
                _fallback(f"batch {b}: {int(counts[b, 1].sum())} hits > "
                          f"cap_total={cap_total}")
                return None
            for j, (si, start, nv, cont) in enumerate(
                    padded[b * R:(b + 1) * R]):
                if si >= 0:
                    per_hap_min[si] += int(counts[b, 0, j])

    # walk_mat and its prefix hashes (24 B a lane): graph-static, kept in
    # the graph's memo where walk_mat fits the limit; above it the join
    # builds them for itself
    with span("walk_hashes"):
        if graph.walk_mat.nbytes <= pangenome.WALK_HASHES_MAX_BYTES:
            walk_mat, ph1, ph2 = memoized(
                graph.memo, ("walk_hashes", str(device)),
                lambda: _walk_hashes(graph, device))
        else:
            walk_mat, ph1, ph2 = _walk_hashes(graph, device)
    with span("filter"):
        occ = _finalize(buf_se[:total_hits], buf_id[:total_hits],
                        buf_hap[:total_hits], walk_mat, threshold,
                        len(sp_hi), H, ph=(ph1, ph2))
    if occ is None:
        return None
    occ.n_hits = total_hits
    occ.pack_bytes = pack_bytes
    occ.route = route
    return per_hap_min, occ


def _walk_hashes(graph, device):
    """(walk_mat int64 [H, P], its two prefix-hash tables [H, P+1])."""
    walk_mat, _ = state.graph_tensors(graph, device)
    return (walk_mat,) + tuple(build_ph(walk_mat, poly)
                               for poly in (_POLY1, _POLY2))


def fin_chunk() -> int:
    """Hits per pass of the threshold filter: PHI_TPU_FIN_CHUNK, else
    FIN_CHUNK."""
    return int(os.environ.get("PHI_TPU_FIN_CHUNK", FIN_CHUNK))


def _group_hashes(se, kid, hap, ph, pw, Pp1: int):
    """Per-occurrence (start, span, g1, g2): g1/g2 are 32-bit hashes of the
    group (k-mer id, vertex run walk[hap][s..s+span]), from the flattened
    prefix hashes ph (two [H * Pp1] tables) and the power tables pw."""
    s = se >> 6
    span = se & 63
    i_lo = hap * Pp1 + s
    i_hi = i_lo + span + 1
    sp = (span + 1).clamp(max=pw[0].shape[0] - 1)
    gs = []
    for phi, pwi, mix in ((ph[0], pw[0], 0x27D4EB2F),
                          (ph[1], pw[1], 0x165667B1)):
        rh = (phi[i_hi] - mul32(phi[i_lo], pwi[sp])) & _M32
        gs.append(_fmix32(rh ^ _fmix32(mul32(kid, mix))))
    return s, span, gs[0], gs[1]


def _kmer_stats(kid, g1, g2, acc) -> None:
    """Pass 1 of the filter over one chunk: adds its occurrences to the
    per-k-mer acc = (total, min and max of g1 ^ g2, min and max of
    g1 + g2)."""
    ktot, umin, umax, vmin, vmax = acc
    ktot.index_add_(0, kid, torch.ones_like(kid))
    u = g1 ^ g2
    umin.scatter_reduce_(0, kid, u, "amin")
    umax.scatter_reduce_(0, kid, u, "amax")
    del u
    v = (g1 + g2) & _M32
    vmin.scatter_reduce_(0, kid, v, "amin")
    vmax.scatter_reduce_(0, kid, v, "amax")


def _owners(ag1, ag2, aid, n_amb: int, th: float, kbad_uni):
    """Exact group counts of the ambiguous occurrences by rounds of
    ownership tables: each round, every table slot elects the minimum
    (g1, g2) group among its unplaced occurrences and counts its members.
    Returns (kbad, unresolved, rounds)."""
    AM = max(2 * _bucket_size(n_amb + 1, 1 << 14), 8)
    dev = ag1.device
    unpl = torch.ones(ag1.shape[0], dtype=torch.bool, device=dev)
    gcnt = torch.zeros(ag1.shape[0], dtype=torch.int64, device=dev)
    r = 0
    while r < _OWNER_ROUNDS and bool(unpl.any()):
        slot = (_fmix32((ag1 + ((r * 0x9E3779B9) & _M32)) & _M32) ^ ag2) \
            & (AM - 1)
        t1 = torch.full((AM,), _M32, dtype=torch.int64, device=dev)
        t1.scatter_reduce_(0, slot, torch.where(unpl, ag1, _M32), "amin")
        cand = unpl & (t1[slot] == ag1)
        t2 = torch.full((AM,), _M32, dtype=torch.int64, device=dev)
        t2.scatter_reduce_(0, slot, torch.where(cand, ag2, _M32), "amin")
        win = cand & (t2[slot] == ag2)
        cnt_r = torch.zeros(AM, dtype=torch.int64, device=dev)
        cnt_r.index_add_(0, slot, win.long())
        gcnt = torch.where(win, cnt_r[slot], gcnt)
        unpl = unpl & ~win
        r += 1
    kbad = kbad_uni.clone()
    kbad[aid[gcnt.float() >= th]] = True
    return kbad, bool(unpl.any()), r


def _finalize(se, kid, hap, walk_mat, threshold: float, Ksp: int,
              H: int, ph=None) -> DeviceOcc | None:
    """The reference's threshold filter over all hits, in passes over
    chunks of fin_chunk() hits (one chunk below it), as the reference's
    _finalize_chunked runs it:
      pass 1: per k-mer occurrence totals and the min/max of two group
              hashes (a k-mer whose occurrences all hash alike is one
              group);
      then:   the ambiguous k-mers (hot and not uniform), their occurrence
              count exact from the totals;
      pass 2a: gather the ambiguous occurrences' hashes into buffers of
              exactly that size;
      then:   the ownership loop, once, over all of them;
      pass 2b: compact each chunk's retained multi-vertex occurrences, in
              chunk order.
    ph: walk_mat's two prefix-hash tables, built here when None.
    None when the ownership loop leaves groups unresolved."""
    dev = se.device
    n = se.shape[0]
    ch = max(1, min(fin_chunk(), n))
    chunks = [slice(c, c + ch) for c in range(0, max(n, 1), ch)]
    th = float(np.float32(threshold * H))
    if ph is None:
        ph = [build_ph(walk_mat, poly) for poly in (_POLY1, _POLY2)]
    ph = [p.reshape(-1) for p in ph]
    pw = [torch.from_numpy(p).to(dev) for p in pw_tables()]
    Pp1 = walk_mat.shape[1] + 1

    def hashes(c):
        return _group_hashes(se[c], kid[c], hap[c], ph, pw, Pp1)[2:]

    def full(init):
        return torch.full((Ksp,), init, dtype=torch.int64, device=dev)

    acc = (full(0), full(_M32), full(0), full(_M32), full(0))
    for c in chunks:
        _kmer_stats(kid[c], *hashes(c), acc)
    ktot, umin, umax, vmin, vmax = acc
    uniform = (umin == umax) & (vmin == vmax)
    del umin, umax, vmin, vmax
    hot = ktot.float() >= th
    k_amb = ~uniform & hot
    # sized exactly from the totals: an estimate here once sent whole
    # real-data runs to the host path in the reference
    n_amb = int(ktot[k_amb].sum())
    ag1, ag2, aid = (torch.empty(n_amb, dtype=torch.int64, device=dev)
                     for _ in range(3))
    off = 0
    for c in chunks:
        amb = k_amb[kid[c]]
        m = int(amb.sum())
        if m:
            g1, g2 = hashes(c)
            ag1[off:off + m] = g1[amb]
            ag2[off:off + m] = g2[amb]
            aid[off:off + m] = kid[c][amb]
            del g1, g2
        off += m
    kbad, unresolved, rounds = _owners(ag1, ag2, aid, n_amb, th,
                                       uniform & hot)
    del ag1, ag2, aid
    if unresolved:
        _fallback(f"ownership loop unresolved after {_OWNER_ROUNDS} rounds")
        return None
    per_hap = torch.zeros(H, dtype=torch.int64, device=dev)
    kmulti = torch.zeros(Ksp, dtype=torch.bool, device=dev)
    multis = []
    for c in chunks:
        keep = ~kbad[kid[c]]
        per_hap += torch.bincount(hap[c][keep], minlength=H)
        multi = keep & ((se[c] & 63) > 0)
        kmulti[kid[c][multi]] = True
        multis.append(multi)
    n_occ = int(sum(int(m.sum()) for m in multis))
    cols = [torch.empty(n_occ, dtype=torch.int64, device=dev)
            for _ in range(4)]
    off = 0
    for c, multi in zip(chunks, multis):
        m = int(multi.sum())
        for col, src in zip(cols, (se[c] >> 6, se[c] & 63, kid[c], hap[c])):
            col[off:off + m] = src[multi]
        off += m
    o_s, o_span, o_id, o_hap = cols
    return DeviceOcc(
        dev_s=o_s, dev_span=o_span, dev_id=o_id, dev_hap=o_hap,
        dev_w=torch.ones(n_occ, dtype=torch.float32, device=dev),
        n_occ=n_occ, n_model=int(kmulti.sum()),
        filtered=int((kbad & (ktot > 0)).sum()),
        per_hap_anchors=per_hap.cpu().numpy().astype(np.int64),
        max_span=int(o_span.max()) if n_occ else 0, n_chunks=len(chunks),
        n_amb=n_amb, owner_rounds=rounds)
