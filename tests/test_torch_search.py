"""Cuckoo spectrum table: the port builds the same table and seed as
phi_tpu's make_cuckoo, and its torch probe returns the same (found, slot)
as pair_isin_cuckoo_slot, dead (UMAX, UMAX) queries included."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from phi_tpu.ops import search as js  # noqa: E402
from phi_tpu_torch import state  # noqa: E402
from phi_tpu_torch.ops import search as ts  # noqa: E402

M32 = 0xFFFFFFFF


def _spectrum(rng, n):
    hi = rng.integers(0, 1 << 30, n, dtype=np.uint64)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    key = np.unique((hi << np.uint64(32)) | lo)
    return ((key >> np.uint64(32)).astype(np.uint32),
            (key & np.uint64(M32)).astype(np.uint32))


@pytest.mark.parametrize("n", [1, 700, 50_000])
def test_make_cuckoo_same_table(n):
    sp_hi, sp_lo = _spectrum(np.random.default_rng(n), n)
    want = js.make_cuckoo(sp_hi, sp_lo)
    got = ts.make_cuckoo(sp_hi, sp_lo)
    for a, b in zip(want[:3], got[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert int(want[3]) == int(got[3]) and want[4] == got[4]


def test_make_cuckoo_empty_is_none():
    z = np.zeros(0, np.uint32)
    assert ts.make_cuckoo(z, z) is None


def test_probe_matches_pair_isin_cuckoo_slot():
    rng = np.random.default_rng(1)
    sp_hi, sp_lo = _spectrum(rng, 20_000)
    Thi, Tlo, Tid, seed, _ = ck = ts.make_cuckoo(sp_hi, sp_lo)
    # members, random non-members and dead (UMAX, UMAX) queries
    pick = rng.integers(0, len(sp_hi), 3000)
    q_hi = np.concatenate([sp_hi[pick],
                           rng.integers(0, 1 << 30, 3000).astype(np.uint32),
                           np.full(500, M32, np.uint32)])
    q_lo = np.concatenate([sp_lo[pick],
                           rng.integers(0, 1 << 32, 3000).astype(np.uint32),
                           np.full(500, M32, np.uint32)])
    f_want, s_want = js.pair_isin_cuckoo_slot(
        jnp.asarray(Thi), jnp.asarray(Tlo), jnp.uint32(seed),
        jnp.asarray(q_hi.reshape(2, -1)), jnp.asarray(q_lo.reshape(2, -1)))
    tkey, tid, tseed = state.cuckoo_tensors(ck, "cpu")
    q = state.spectrum_keys(q_hi, q_lo, "cpu").reshape(2, -1)
    f_got, s_got = ts.probe_cuckoo_slot(tkey, tseed, q)
    assert np.array_equal(f_got.numpy(), np.asarray(f_want))
    assert np.array_equal(s_got.numpy(), np.asarray(s_want))
    found = f_got.numpy().ravel()
    assert found[:3000].all()
    # slots map back to the spectrum ids of the members
    ids = tid.numpy()[s_got.numpy().ravel()[:3000]]
    assert np.array_equal(ids, pick)
