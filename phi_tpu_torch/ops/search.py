"""The read-spectrum tables of the join and their probes.

`make_cuckoo` (the two-choice cuckoo table) and `make_mixed_buckets` (the
mixed-key sorted table, for spectra of more than CUCKOO_MAX_KEYS keys and
for the v1 join) are the host numpy builds of `phi_tpu/ops/search.py`
(same hashes, seeds, placement and order, so both packages build the same
tables). The probes are torch gathers on int64 keys; the 32-bit hashes run
in int64 lanes masked to 32 bits after every multiply and add. `pair_isin`
is the sorted-key binary search of the single-sequence join.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CUCKOO_MAX_KEYS = 8_000_000   # tables are 24 B/key at load 0.5
_CK1 = 0x9E3779B1
_CK2 = 0x85EBCA77
_CK3 = 0xC2B2AE35
_CK4 = 0x27D4EB2F
_M32 = 0xFFFFFFFF


def _ck_mix_np(x):
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = x * np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x = x * np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def _ck_h_np(hi, lo, c1, c2, seed, M):
    return (_ck_mix_np(hi * np.uint32(c1) + lo * np.uint32(c2)
                       + np.uint32(seed))
            & np.uint32(M - 1)).astype(np.int64)


def make_cuckoo(sp_hi_np, sp_lo_np, max_attempts: int = 3):
    """(Thi, Tlo, Tid, seed, M) or None (empty or oversized spectrum, or a
    failed build). Thi/Tlo hold UMAX at empty slots (a canonical
    (UMAX, UMAX) pair is impossible for k <= 31; a k > 31 key folded to 64
    bits equals it with probability 2^-64, as in the reference)."""
    n = len(sp_hi_np)
    if n == 0 or n > CUCKOO_MAX_KEYS:
        return None
    hi = sp_hi_np.astype(np.uint32)
    lo = sp_lo_np.astype(np.uint32)
    M = 1 << max(10, int(np.ceil(np.log2(2 * n))))
    for attempt in range(max_attempts):
        seed = (0x1234ABCD + attempt * 0x9E3779B9) & 0xFFFFFFFF
        h1 = _ck_h_np(hi, lo, _CK1, _CK2, seed, M)
        h2 = _ck_h_np(hi, lo, _CK3, _CK4, seed ^ 0x55555555, M)
        slot = np.full(M, -1, np.int64)
        pend = np.arange(n)
        use2 = np.zeros(n, bool)
        for _ in range(48):
            if not len(pend):
                break
            h = np.where(use2[pend], h2[pend], h1[pend])
            empty = slot[h] == -1
            cand = pend[empty]
            hc = h[empty]
            uh, first = np.unique(hc, return_index=True)
            slot[uh] = cand[first]
            placed = np.zeros(n, bool)
            placed[cand[first]] = True
            pend = pend[~placed[pend]]
            use2[pend] = ~use2[pend]
        if len(pend) > 65536:
            M *= 2
            continue
        ok = True
        for i in pend.tolist():  # sequential eviction for stragglers
            cur, h = i, int(h1[i])
            for _ in range(500):
                if slot[h] == -1:
                    slot[h] = cur
                    break
                slot[h], cur = cur, slot[h]
                h = int(h2[cur]) if h == int(h1[cur]) else int(h1[cur])
            else:
                ok = False
                break
        if not ok:
            M *= 2
            continue
        occ = slot >= 0
        si = np.where(occ, slot, 0)
        Thi = np.where(occ, hi[si], np.uint32(0xFFFFFFFF)).astype(np.uint32)
        Tlo = np.where(occ, lo[si], np.uint32(0xFFFFFFFF)).astype(np.uint32)
        Tid = np.where(occ, slot, -1).astype(np.int32)
        return Thi, Tlo, Tid, np.uint32(seed), M
    return None


def pair_isin(sp_key: torch.Tensor, q: torch.Tensor):
    """(found, index) of int64 query keys in the sorted int64 spectrum keys
    (state.spectrum_keys: (hi << 32) | lo, which sorts like (hi, lo) for
    k <= 31); index is the searchsorted position."""
    n = sp_key.shape[0]
    idx = torch.searchsorted(sp_key, q)
    if n == 0:
        return torch.zeros(q.shape, dtype=torch.bool, device=q.device), idx
    found = (idx < n) & (sp_key[idx.clamp(max=n - 1)] == q)
    return found, idx


def mul32(x: torch.Tensor, y) -> torch.Tensor:
    """(x * y) mod 2^32 for u32 values held in int64 lanes; y is a tensor
    of such values or a constant below 2^32. torch int64 products wrap
    mod 2^64, which keeps the low 32 bits exact."""
    return (x * y) & _M32


# Mixed-key table, for spectra the cuckoo table does not take: sorted by
# (m, lo) with m = hi*C1 + lo*C2 mod 2^32, which identifies (hi, lo) since C1
# is odd and spreads skewed minimizer values evenly over first-probe buckets
# of the top `bits` of m; perm maps a sorted position to the spectrum id.
MIX_C1 = 0x9E3779B1
MIX_C2 = 0x85EBCA77
MIXED_BUCKET_BITS = 16


def mixed_bits_for(bucket: int) -> int:
    """First-probe width for a spectrum of `bucket` keys: about one key
    per bucket, from 16 to 22 bits."""
    return min(22, max(MIXED_BUCKET_BITS, (max(bucket, 2) - 1).bit_length()))


def mix_key_np(hi, lo):
    return (hi.astype(np.uint32) * np.uint32(MIX_C1)
            + lo.astype(np.uint32) * np.uint32(MIX_C2))


def make_mixed_buckets(sp_hi_np, sp_lo_np, bits: int):
    """Host build of the mixed-key table: (m_sorted, lo_sorted, perm, off,
    rounds), off the first sorted position of each of the 2^bits buckets
    (plus the end) and rounds the bisection depth of the fullest bucket."""
    m = mix_key_np(sp_hi_np, sp_lo_np)
    order = np.lexsort((sp_lo_np, m)).astype(np.int32)
    m_sorted = m[order]
    lo_sorted = sp_lo_np[order]
    thresholds = (np.arange((1 << bits) + 1, dtype=np.uint64)
                  << np.uint64(32 - bits))
    thresholds = np.minimum(thresholds,
                            np.uint64(0xFFFFFFFF)).astype(np.uint32)
    off = np.searchsorted(m_sorted, thresholds, side="left").astype(np.int32)
    off[-1] = len(m_sorted)
    max_bucket = int(np.diff(off).max()) if len(off) > 1 else len(m_sorted)
    rounds = max(1, math.ceil(math.log2(max_bucket + 1)))
    return m_sorted, lo_sorted, order, off, rounds


def pair_isin_mixed(sp_m, sp_lo, perm, bucket_off, q: torch.Tensor,
                    rounds: int, bits: int):
    """(found, spectrum id) of int64 query keys against a mixed-key table
    held as int64 columns (sp_m and sp_lo hold u32 values): `rounds`
    bisection steps inside the query's first-probe bucket over (m, lo) as
    two columns. Slots with perm -1 (sentinel pads) never match."""
    n = sp_m.shape[0]
    if n == 0:
        return (torch.zeros(q.shape, dtype=torch.bool, device=q.device),
                torch.zeros(q.shape, dtype=torch.int64, device=q.device))
    qh = (q >> 32) & _M32
    ql = q & _M32
    qm = (mul32(qh, MIX_C1) + mul32(ql, MIX_C2)) & _M32
    b = qm >> (32 - bits)
    lo = bucket_off[b]
    hi = bucket_off[b + 1]
    for _ in range(rounds):
        active = lo < hi
        mid = (lo + hi) >> 1
        mid_c = mid.clamp(max=n - 1)
        mm = sp_m[mid_c]
        less = (mm < qm) | ((mm == qm) & (sp_lo[mid_c] < ql))
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    idx = lo.clamp(max=n - 1)
    found = (lo < n) & (sp_m[idx] == qm) & (sp_lo[idx] == ql)
    ids = perm[idx]
    return found & (ids >= 0), ids


def mixed_tensors(sp_hi, sp_lo, device):
    """The mixed-key table of a spectrum on `device`: (m, lo, perm, off)
    int64 tensors, then rounds and bits, in pair_isin_mixed's order."""
    sp_hi = np.asarray(sp_hi, np.uint32)
    sp_lo = np.asarray(sp_lo, np.uint32)
    bits = mixed_bits_for(len(sp_hi))
    *cols, rounds = make_mixed_buckets(sp_hi, sp_lo, bits)
    return tuple(torch.from_numpy(np.asarray(c, np.int64)).to(device)
                 for c in cols) + (rounds, bits)


def ck_mix(x: torch.Tensor) -> torch.Tensor:
    """The probe's 32-bit finalizer on int64 lanes holding u32 values."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def probe_cuckoo_slot(tkey: torch.Tensor, seed: int, q: torch.Tensor):
    """(found, slot) for int64 query keys against a cuckoo table held as
    int64 keys tkey [M] ((Thi << 32) | Tlo, -1 at empty slots): slot is the
    matching table slot or -1. Dead queries (-1) match empty slots; callers
    mask them out by their packed interval."""
    M = tkey.shape[0]
    qh = (q >> 32) & _M32
    ql = q & _M32
    p1 = ck_mix((mul32(qh, _CK1) + mul32(ql, _CK2) + seed) & _M32) & (M - 1)
    p2 = ck_mix((mul32(qh, _CK3) + mul32(ql, _CK4)
                 + (seed ^ 0x55555555)) & _M32) & (M - 1)
    hit1 = tkey[p1] == q
    hit2 = tkey[p2] == q
    slot = torch.where(hit1, p1, torch.where(hit2, p2, -1))
    return hit1 | hit2, slot
