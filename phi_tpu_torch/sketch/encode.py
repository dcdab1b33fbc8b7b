"""Minimizer key helpers: the port's copy of what it needs of
`phi_tpu/sketch/encode.py`."""

from __future__ import annotations

import numpy as np


def combine64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) uint32 halves -> one uint64 key; keeps lexicographic order."""
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
