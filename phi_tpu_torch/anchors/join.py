"""Anchor tables: what the solver needs from the join, plus the stats of the
[M::] log contract. The port of `phi_tpu/anchors/join.py`'s `AnchorTables`,
the credit arrays and `anchor_tables_from_hits`, which builds the tables on
the host from per-haplotype join hits (the hit path of `--save-index` and
`--load-index`) through the native library. `_anchor_tables_from_hits_py`
is the JAX package's numpy reference of that call, kept for the tests; the
run path has no fallback to it. The device-anchor route builds its tables
in anchors/device.py. `sketch_haplotypes` (per-walk minimizers, on the seq
kernel) and `build_anchor_tables` (their join against a read spectrum on
the host) serve `-d` and the frontier runner.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from phi_tpu_torch import native
from phi_tpu_torch.graph.pangenome import PangenomeGraph
from phi_tpu_torch.sketch.encode import combine64
from phi_tpu_torch.sketch.kernels import NARROW_MAX_K, sketch_sequence


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
    # what the solver derives from this sample's occurrence columns (the
    # first occurrence of each k-mer, the lanes' start order, the hit
    # path's device index columns), keyed by (name, parameters...);
    # dataclasses.replace carries it to the ladder's rounds, which change
    # only occ_weight
    memo: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)

    @classmethod
    def on_device(cls, per_hap_minimizers, occ, spectrum_size: int
                  ) -> "AnchorTables":
        """The tables of the device anchors' DeviceOcc `occ`, the host
        columns left for materialize_device."""
        return cls(occ_hap=None, occ_start=None, occ_end=None, occ_kmer=None,
                   occ_weight=None, n_model_kmers=occ.n_model,
                   spectrum_size=spectrum_size, filtered_kmers=occ.filtered,
                   per_hap_minimizers=per_hap_minimizers,
                   per_hap_anchors=occ.per_hap_anchors, device_occ=occ)

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


def sketch_haplotypes(graph: PangenomeGraph, k: int, w: int, *, device
                      ) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Per-walk minimizers (hi, lo, base position), the reference's
    index_kmers: the seq kernel on `device` for k <= 31, the native scan
    for 31 < k <= 63 (folded keys), as the JAX package does."""
    out = []
    for h in range(graph.num_walks):
        codes = graph.walk_seq_codes(h)
        if k > NARROW_MAX_K:
            out.append(native.minimizers_native(codes, k, w))
        else:
            out.append(sketch_sequence(codes, k, w, device=device))
    return out


def build_anchor_tables(graph: PangenomeGraph, k: int,
                        hap_sketches: list[tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]],
                        read_spectrum: tuple[np.ndarray, np.ndarray],
                        threshold: float) -> AnchorTables:
    """Anchor tables from per-walk sketches and a sorted read spectrum
    (hi, lo): each walk's minimizers joined against the spectrum by binary
    search on the host, then anchor_tables_from_hits."""
    sp_key = combine64(*read_spectrum)
    spectrum_size = len(sp_key)
    hits: list[tuple[int, np.ndarray, np.ndarray]] = []
    for hi, lo, pos in hap_sketches:
        if len(hi) == 0 or spectrum_size == 0:
            hits.append((len(hi), np.zeros(0, np.int32),
                         np.zeros(0, np.int32)))
            continue
        key = combine64(hi, lo)
        idx = np.searchsorted(sp_key, key)
        hit = sp_key[np.minimum(idx, spectrum_size - 1)] == key
        hits.append((len(hi), pos[hit].astype(np.int32),
                     idx[hit].astype(np.int32)))
    return anchor_tables_from_hits(graph, k, hits, spectrum_size, threshold)


def anchor_tables_from_hits(graph: PangenomeGraph, k: int,
                            hits: list[tuple[int, np.ndarray, np.ndarray]],
                            spectrum_size: int,
                            threshold: float) -> AnchorTables:
    """Solver tables from per-hap join hits, hits[h] = (n_minimizers, k-mer
    start base positions (ascending), spectrum ids), by the native
    single-pass kernel: the reference's compute_anchors and threshold
    filter. Raises if the library is missing or a haplotype's positions are
    not ascending."""
    H = graph.num_walks
    per_hap_min = np.array([hits[h][0] for h in range(H)], np.int64)
    nat = native.anchors_native(graph, k, hits, spectrum_size, threshold)
    if nat is None:
        raise RuntimeError("native anchor tables failed (the library is "
                           "missing, or hit positions are not ascending)")
    occ_hap, occ_start, occ_end, occ_kmer, n_model, filtered, per_hap = nat
    return AnchorTables(
        occ_hap=occ_hap, occ_start=occ_start, occ_end=occ_end,
        occ_kmer=occ_kmer, occ_weight=np.ones(len(occ_hap), np.float32),
        n_model_kmers=n_model, spectrum_size=spectrum_size,
        filtered_kmers=filtered, per_hap_minimizers=per_hap_min,
        per_hap_anchors=per_hap)


_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64-style finalizer for run-identity hashing."""
    x ^= x >> np.uint64(30)
    x = x * _M1
    x ^= x >> np.uint64(27)
    x = x * _M2
    x ^= x >> np.uint64(31)
    return x


def _run_hashes(graph: PangenomeGraph, hap: np.ndarray, start: np.ndarray,
                end: np.ndarray) -> np.ndarray:
    """Order-sensitive hash of the vertex run walk[h][s..e] per occurrence:
    it stands in for the reference's stringified vertex path, the anchor
    group key (`anchor_str`, ILP_index.cpp:680-683)."""
    n = len(hap)
    h = np.ones(n, dtype=np.uint64)
    if n == 0:
        return h
    span = (end - start).astype(np.int64)
    wm_flat = graph.walk_mat.reshape(-1).astype(np.uint64)
    P = graph.walk_mat.shape[1]
    flat = hap.astype(np.int64) * P + start.astype(np.int64)
    for j in range(int(span.max()) + 1):
        act = span >= j
        vtx = wm_flat[flat + j * act]  # inactive rows re-read j=0 (masked out)
        h = np.where(act, _mix64(h ^ vtx), h)
    return h


def _anchor_tables_from_hits_py(graph: PangenomeGraph, k: int,
                                hits: list[tuple[int, np.ndarray, np.ndarray]],
                                spectrum_size: int,
                                threshold: float) -> AnchorTables:
    """The numpy reference of anchor_tables_from_hits: base intervals
    [pos, pos+k-1] to walk positions by the node offsets, then the threshold
    filter (ILP_index.cpp:670-722): occurrences of each spectrum k-mer are
    grouped by identical vertex run, and a k-mer whose group count reaches
    threshold * H is dropped whole."""
    H = graph.num_walks
    parts_h, parts_s, parts_e, parts_id = [], [], [], []
    per_hap_minimizers = np.zeros(H, dtype=np.int64)
    for h in range(H):
        n_min, pos_hit, sp_id = hits[h]
        per_hap_minimizers[h] = n_min
        if len(pos_hit) == 0:
            continue
        pos_hit = pos_hit.astype(np.int64)
        cl = graph.walk_node_cumlen[h]
        s = np.searchsorted(cl, pos_hit, side="right") - 1
        e = np.searchsorted(cl, pos_hit + k - 1, side="right") - 1
        parts_h.append(np.full(len(pos_hit), h, dtype=np.int32))
        parts_s.append(s.astype(np.int32))
        parts_e.append(e.astype(np.int32))
        parts_id.append(sp_id.astype(np.int32))

    def cat(parts):
        return np.concatenate(parts) if parts else np.zeros(0, np.int32)
    occ_hap, occ_start, occ_end, occ_kmer = (
        cat(p) for p in (parts_h, parts_s, parts_e, parts_id))

    filtered_kmers = 0
    keep_occ = np.ones(len(occ_hap), bool)
    if len(occ_hap):
        run_h = _run_hashes(graph, occ_hap, occ_start, occ_end)
        group = (_mix64(occ_kmer.astype(np.uint64) ^ run_h)) & _U64
        _, inv, counts = np.unique(group, return_inverse=True,
                                   return_counts=True)
        occ_bad = (counts.astype(np.float64) >= threshold * H)[inv]
        bad_kmers = np.unique(occ_kmer[occ_bad])
        filtered_kmers = len(bad_kmers)
        keep_occ = ~np.isin(occ_kmer, bad_kmers)

    per_hap_anchors = np.bincount(occ_hap[keep_occ],
                                  minlength=H).astype(np.int64)
    # solver intervals: retained multi-vertex occurrences only
    multi = keep_occ & (occ_end > occ_start)
    return AnchorTables(
        occ_hap=occ_hap[multi], occ_start=occ_start[multi],
        occ_end=occ_end[multi], occ_kmer=occ_kmer[multi],
        occ_weight=np.ones(multi.sum(), np.float32),
        n_model_kmers=len(np.unique(occ_kmer[multi])),
        spectrum_size=spectrum_size, filtered_kmers=filtered_kmers,
        per_hap_minimizers=per_hap_minimizers,
        per_hap_anchors=per_hap_anchors)
