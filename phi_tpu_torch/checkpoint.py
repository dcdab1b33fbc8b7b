"""Index checkpointing — save/restore the expensive intermediate state (the
port's copy of `phi_tpu/checkpoint.py`: the same `.npz` keys, so an index
written by either package loads in the other).

The reference recomputes everything per run (SURVEY.md §5: no
checkpoint/resume). Here the read spectrum and per-hap join hits can be
persisted, so re-solves with different solver parameters (R, threshold,
Lagrangian settings) skip sketching entirely.
"""

from __future__ import annotations

import numpy as np


def _norm_path(path: str) -> str:
    """np.savez appends '.npz' when absent; normalize so save/load agree."""
    return path if path.endswith(".npz") else path + ".npz"


def save_index(path: str, spectrum: tuple[np.ndarray, np.ndarray],
               hits: list[tuple[int, np.ndarray, np.ndarray]],
               meta: dict | None = None) -> None:
    arrays: dict[str, np.ndarray] = {
        "sp_hi": spectrum[0], "sp_lo": spectrum[1],
        "n_haps": np.array([len(hits)], np.int64),
    }
    for h, (n_min, pos, sid) in enumerate(hits):
        arrays[f"h{h}_nmin"] = np.array([n_min], np.int64)
        arrays[f"h{h}_pos"] = pos
        arrays[f"h{h}_sid"] = sid
    for k, v in (meta or {}).items():
        arrays[f"meta_{k}"] = np.asarray(v)
    np.savez_compressed(_norm_path(path), **arrays)


def load_index(path: str):
    """Returns (spectrum, hits, meta)."""
    z = np.load(_norm_path(path))
    spectrum = (z["sp_hi"], z["sp_lo"])
    n = int(z["n_haps"][0])
    hits = [(int(z[f"h{h}_nmin"][0]), z[f"h{h}_pos"], z[f"h{h}_sid"])
            for h in range(n)]
    meta = {k[len("meta_"):]: z[k] for k in z.files if k.startswith("meta_")}
    return spectrum, hits, meta
