"""Card tests of the port: the rows3, rows3w and rows2 CUDA kernels against
their plain twins on the same CUDA tensors, at the main path's shape. They
skip without a CUDA device. This file imports no jax, so it also runs where
jax is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from phi_tpu_torch.sketch import kernels as tk


def _inputs(seed, sb, rows=8):
    rng = np.random.default_rng(seed)
    row_lanes = (sb + 1) * tk.BLK
    codes = torch.from_numpy(rng.integers(0, 4, (rows, row_lanes),
                                          dtype=np.uint8))
    nd = torch.from_numpy((rng.random((rows, row_lanes)) < 0.06)
                          .astype(np.uint8))
    nd[:, 0] = 0
    full = sb * tk.BLK
    nvalid = torch.tensor([full, 1000, 0, 5 * tk.BLK + 7] * (rows // 4),
                          dtype=torch.int32)
    left = torch.tensor([-1, 2, -1, 0] * (rows // 4), dtype=torch.int32)
    node_off = tk.block_node_offsets(
        nd, torch.from_numpy(rng.integers(0, 99, rows).astype(np.int32)), sb)
    return codes, nd, nvalid, left, node_off


@pytest.mark.cuda
@pytest.mark.parametrize("k,w,C", [(31, 25, None), (21, 11, None),
                                   (15, 5, 256)])
def test_rows3_kernel_matches_twin_on_card(k, w, C):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    C = C or tk.block_cap(w)
    args = tuple(a.cuda() for a in _inputs(k, tk.SUPER_BLOCKS))
    want = tk.sketch_rows3_torch(*args, k, w, C)
    before = tk.sketch_rows3.launches
    got = tk.sketch_rows3(*args, k, w, C)
    torch.cuda.synchronize()
    assert tk.sketch_rows3.launches == before + 1
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("k,w", [(35, 25), (63, 11)])
def test_rows3w_kernel_matches_twin_on_card(k, w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    C = tk.block_cap(w)
    args = tuple(a.cuda() for a in _inputs(k, tk.SUPER_BLOCKS))
    want = tk.sketch_rows3w_torch(*args, k, w, C)
    before = tk.sketch_rows3w.launches
    got = tk.sketch_rows3w(*args, k, w, C)
    torch.cuda.synchronize()
    assert tk.sketch_rows3w.launches == before + 1
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_rows2_kernel_matches_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = tuple(a.cuda() for a in _inputs(2, tk.SUPER_BLOCKS))
    want = tk.sketch_rows2_torch(*args, 31, 25)
    before = tk.sketch_rows2.launches
    got = tk.sketch_rows2(*args, 31, 25)
    torch.cuda.synchronize()
    assert tk.sketch_rows2.launches == before + 1
    for a, b in zip(want, got):
        assert torch.equal(a, b)
