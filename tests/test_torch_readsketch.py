"""The device read sketch (sketch/minimizer.py: sketch_read_concat on a
mesh's devices or under PHI_TPU_DEVICE_READ_SKETCH=1, sketch_read_batch) on
1, 2, 3 and 8 CPU shards, through the seq kernel's twin: the spectrum
(hi, lo) equal to phi_tpu's sketch_read_concat on as many of the
conftest's virtual CPU devices, to phi_tpu's sketch_read_batch and to the
port's native scan (pipeline.read_spectrum), on reads holding N, reads
shorter than one window and a read boundary at an 8192-lane block edge;
more shards than reads; and k = 35 on the device route, which raises as
in phi_tpu."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from phi_tpu.sketch import minimizer as jmin  # noqa: E402
from phi_tpu_torch.io.reads import ReadBatch  # noqa: E402
from phi_tpu_torch.pipeline import read_spectrum  # noqa: E402
from phi_tpu_torch.sketch import minimizer as tmin  # noqa: E402
from phi_tpu_torch.sketch.kernels import BLK  # noqa: E402

KW = [(31, 25), (21, 11), (5, 3)]
CPU = torch.device("cpu")


def _reads(seed: int = 0, n_reads: int = 90):
    """(concat, off): reads of 20-199 bases with scattered N and a few N
    runs, one read ending exactly at lane 8192, and reads shorter than a
    window of (31, 25)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(20, 200, n_reads)
    lens[5:9] = [3, 30, 54, 1]          # shorter than k + w - 1 = 55
    cut = np.searchsorted(np.cumsum(lens), BLK)
    lens[cut] += BLK - np.cumsum(lens)[cut]
    assert np.cumsum(lens)[cut] == BLK and lens[cut] > 0
    concat = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
    concat[rng.integers(0, len(concat), 40)] = 4
    for s in rng.integers(0, len(concat) - 40, 4):
        concat[s:s + 35] = 4            # runs longer than a k-mer
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return concat, off


def _padded(concat, off):
    lens = np.diff(off).astype(np.int32)
    codes = np.full((len(lens), lens.max()), 4, np.uint8)
    for i, n in enumerate(lens):
        codes[i, :n] = concat[off[i]:off[i + 1]]
    return codes, lens


def _equal(a, b):
    assert a[0].dtype == b[0].dtype == np.uint32
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.fixture(scope="module")
def reads():
    return _reads()


@pytest.fixture(scope="module")
def want(reads):
    """phi_tpu's sketch_read_batch and the port's native scan, per (k, w),
    which must agree."""
    concat, off = reads
    codes, lens = _padded(concat, off)
    out = {}
    for k, w in KW:
        native = read_spectrum(ReadBatch(np.diff(off).astype(np.int32), [],
                                         concat=concat, off=off), k, w)
        _equal(jmin.sketch_read_batch(codes, k, w, lens), native)
        out[k, w] = native
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("k,w", KW)
def test_device_read_sketch_matches(reads, want, monkeypatch, k, w, n):
    concat, off = reads
    if n == 1:
        # one device takes the device route only when asked
        monkeypatch.setenv("PHI_TPU_DEVICE_READ_SKETCH", "1")
    got = tmin.sketch_read_concat(concat, off, k, w, devices=[CPU] * n)
    _equal(got, want[k, w])
    _equal(got, jmin.sketch_read_concat(concat, off, k, w,
                                        devices=jax.devices()[:n]))
    assert len(got[0]) > 0


@pytest.mark.parametrize("k,w", KW)
def test_sketch_read_batch_matches(reads, want, k, w):
    concat, off = reads
    codes, lens = _padded(concat, off)
    _equal(tmin.sketch_read_batch(codes, k, w, lens, device=CPU),
           want[k, w])
    # lengths inferred from the trailing pad run
    _equal(tmin.sketch_read_batch(codes, k, w, device=CPU),
           jmin.sketch_read_batch(codes, k, w))


def test_more_shards_than_reads():
    rng = np.random.default_rng(4)
    concat = rng.integers(0, 4, 490).astype(np.uint8)
    concat[200] = 4
    off = np.array([0, 150, 190, 490], np.int64)
    got = tmin.sketch_read_concat(concat, off, 21, 11, devices=[CPU] * 8)
    _equal(got, jmin.sketch_read_concat(concat, off, 21, 11,
                                        devices=jax.devices()[:8]))
    _equal(got, tmin.native_spectrum(concat, off, 21, 11))


def test_one_device_takes_the_native_scan(reads, want, monkeypatch):
    """Without PHI_TPU_DEVICE_READ_SKETCH=1 one device runs the native
    scan, and the seq kernel's wrapper is not called."""
    from phi_tpu_torch.sketch import kernels
    calls = []
    monkeypatch.setattr(kernels, "sketch_seq",
                        lambda *a: calls.append(a) or None)
    monkeypatch.delenv("PHI_TPU_DEVICE_READ_SKETCH", raising=False)
    concat, off = reads
    _equal(tmin.sketch_read_concat(concat, off, 31, 25, device=CPU),
           want[31, 25])
    assert calls == []


def test_wide_k_on_the_device_route_raises(reads, monkeypatch):
    concat, off = reads
    monkeypatch.setenv("PHI_TPU_DEVICE_READ_SKETCH", "1")
    with pytest.raises(RuntimeError, match="needs the native scanner"):
        jmin.sketch_read_concat(concat, off, 35, 25)
    with pytest.raises(RuntimeError, match="needs the native scanner"):
        tmin.sketch_read_concat(concat, off, 35, 25, device=CPU)
    with pytest.raises(RuntimeError, match="needs the native scanner"):
        tmin.sketch_read_concat(concat, off, 35, 25, devices=[CPU] * 2)
