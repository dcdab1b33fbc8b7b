"""Anchor tables: what the solver needs from the join, plus the stats of the
[M::] log contract. The jax-free counterpart of `phi_tpu/anchors/join.py`
(`AnchorTables` and the credit arrays); the host hit path that builds them
from per-hap hits is not ported (the device path in anchors/device.py is).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from phi_tpu.graph.pangenome import PangenomeGraph


@dataclasses.dataclass
class AnchorTables:
    """Retained multi-vertex occurrences and the log-contract stats. On the
    device path the occurrence columns start as None with `device_occ`
    holding them on the device; materialize_device() copies them to the
    host before decode or refinement reads them."""

    occ_hap: np.ndarray | None     # int32 [n_occ]
    occ_start: np.ndarray | None   # int32 [n_occ] walk position of first vertex
    occ_end: np.ndarray | None     # int32 [n_occ] walk position of last vertex
    occ_kmer: np.ndarray | None    # int32 [n_occ] spectrum id of the k-mer
    occ_weight: np.ndarray | None  # float32 [n_occ] Lagrangian weights
    n_model_kmers: int             # k-mers with >= 1 multi-vertex occurrence
    spectrum_size: int
    filtered_kmers: int            # spectrum k-mers dropped by the filter
    per_hap_minimizers: np.ndarray  # int64 [H]
    per_hap_anchors: np.ndarray     # int64 [H] retained occurrences (incl. span 0)
    device_occ: object | None = None  # anchors.device.DeviceOcc

    def materialize_device(self) -> None:
        if self.device_occ is None or self.occ_hap is not None:
            return
        hap, s, e, kid = self.device_occ.materialize()
        self.occ_hap = hap
        self.occ_start = s
        self.occ_end = e
        self.occ_kmer = kid
        self.occ_weight = np.ones(len(hap), np.float32)


def credit_arrays_from_occ(occ_hap: np.ndarray, occ_start: np.ndarray,
                           occ_end: np.ndarray, occ_weight: np.ndarray,
                           H: int, P: int) -> tuple[np.ndarray, np.ndarray]:
    """The solver's S and B prefix arrays, float32 [H, P] each:
      B[h, p] = total weight of occurrences in lane h with end <= p
      S[h, p] = total weight of occurrences in lane h with start < p"""
    b_idx = occ_hap.astype(np.int64) * P + occ_end
    B = np.bincount(b_idx, weights=occ_weight,
                    minlength=H * P).reshape(H, P).astype(np.float32)
    start_next = occ_start.astype(np.int64) + 1
    in_range = start_next < P
    s_idx = occ_hap[in_range].astype(np.int64) * P + start_next[in_range]
    S = np.bincount(s_idx, weights=occ_weight[in_range],
                    minlength=H * P).reshape(H, P).astype(np.float32)
    return (np.cumsum(S, axis=1, dtype=np.float32),
            np.cumsum(B, axis=1, dtype=np.float32))


def credit_arrays(graph: PangenomeGraph, t: AnchorTables
                  ) -> tuple[np.ndarray, np.ndarray]:
    H, P = graph.walk_mat.shape
    return credit_arrays_from_occ(t.occ_hap, t.occ_start, t.occ_end,
                                  t.occ_weight, H, P)
