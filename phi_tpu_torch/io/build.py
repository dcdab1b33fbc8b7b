"""Programmatic graph construction (tests, synthetic benches): the port's
copy of `phi_tpu/io/build.py`.

Builds a GfaData directly from segment sequences and walks; edges are the
union of consecutive walk pairs plus any extra edges (the same graph shape a
W-line GFA would produce).
"""

from __future__ import annotations

import numpy as np

from phi_tpu_torch.io.gfa import GfaData, encode_seq


def build_gfa_data(segments: dict[str, str],
                   walks: list[tuple[str, list[str]]],
                   extra_edges: list[tuple[str, str]] | None = None) -> GfaData:
    seg_names = list(segments.keys())
    sid = {n: i for i, n in enumerate(seg_names)}
    node_len = np.array([len(segments[n]) for n in seg_names], dtype=np.int64)
    node_off = np.zeros(len(seg_names) + 1, dtype=np.int64)
    np.cumsum(node_len, out=node_off[1:])
    seq_code = encode_seq("".join(segments[n] for n in seg_names))

    edge_set: set[tuple[int, int]] = set()
    walk_arrays: list[np.ndarray] = []
    walk_names: list[str] = []
    for wname, seglist in walks:
        ids = [sid[s] for s in seglist]
        for a, b in zip(ids, ids[1:]):
            edge_set.add((a, b))
        walk_arrays.append(np.array(ids, dtype=np.int32))
        walk_names.append(wname if "." in wname else wname + ".0")
    for a, b in (extra_edges or []):
        edge_set.add((sid[a], sid[b]))

    if edge_set:
        e = np.array(sorted(edge_set), dtype=np.int32)
        edge_u, edge_v = e[:, 0].copy(), e[:, 1].copy()
    else:
        edge_u = np.zeros(0, np.int32)
        edge_v = np.zeros(0, np.int32)

    return GfaData(seg_names=seg_names, node_len=node_len, node_off=node_off,
                   seq_code=seq_code, edge_u=edge_u, edge_v=edge_v,
                   walks=walk_arrays, walk_names=walk_names)
