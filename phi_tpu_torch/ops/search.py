"""Two-choice cuckoo table over the read spectrum, and its probe.

`make_cuckoo` is the host numpy build of `phi_tpu/ops/search.py` (same
hashes, seeds and placement, so both packages build the same table). The
probe is torch gathers on int64 keys; the 32-bit hash runs in int64 lanes
masked to 32 bits after every multiply and add.
"""

from __future__ import annotations

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
    (UMAX, UMAX) pair is impossible for k <= 31)."""
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


def mul32(x: torch.Tensor, y) -> torch.Tensor:
    """(x * y) mod 2^32 for u32 values held in int64 lanes; y is a tensor
    of such values or a constant below 2^32. torch int64 products wrap
    mod 2^64, which keeps the low 32 bits exact."""
    return (x * y) & _M32


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
