"""Tensorized pangenome DAG: the port's copy of `phi_tpu/graph/pangenome.py`.

Dense per-vertex arrays, CSR adjacency, a topological order and padded walk
(lane) tables for the solver. The toposort, the walk-code concatenation and
the vertex -> lane CSR run in the native host library; the port keeps no
pure-Python fallback for them (the pipeline needs the library anyway).

The held panel: one slot keeps the graph that the latest `run_pipeline`
loaded, keyed by its file's identity, so that later inferences against the
unchanged file take that very graph, with the memos that hang off it, and
neither parse nor tensorize it again.
"""

from __future__ import annotations

import dataclasses
import os
import stat
import threading

import numpy as np

from phi_tpu_torch.io.gfa import GfaData, decode_seq
from phi_tpu_torch.native import (lane_csr_native, toposort_native,
                                  walk_codes_native)


@dataclasses.dataclass
class Csr:
    """Grouped values: for key i, values[off[i]:off[i+1]]."""

    off: np.ndarray     # int64 [n_keys + 1]
    values: np.ndarray  # [total]

    def group(self, i: int) -> np.ndarray:
        return self.values[self.off[i]:self.off[i + 1]]


def build_csr(keys: np.ndarray, values: np.ndarray, n_keys: int) -> Csr:
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    off = np.searchsorted(sk, np.arange(n_keys + 1)).astype(np.int64)
    return Csr(off, values[order])


def ragged_arange(counts: np.ndarray, dtype=np.int64) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=dtype)
    starts = np.zeros(len(counts), dtype=dtype)
    np.cumsum(counts[:-1], out=starts[1:])
    return np.arange(total, dtype=dtype) - np.repeat(starts, counts)


@dataclasses.dataclass
class PangenomeGraph:
    gfa: GfaData
    n_vtx: int
    edge_u: np.ndarray          # int32 [E]
    edge_v: np.ndarray          # int32 [E]
    out_adj: Csr                # vertex -> successor vertex ids
    in_adj: Csr                 # vertex -> predecessor vertex ids
    topo_order: np.ndarray      # int32 [n_reach] vertices in topo order
    topo_rank: np.ndarray       # int32 [n_vtx]; rank in topo order
    # Lanes (haplotype walks)
    num_walks: int
    walk_names: list[str]
    walk_mat: np.ndarray        # int32 [H, P] vertex ids, padded with -1
    walk_len: np.ndarray        # int32 [H]
    walk_node_cumlen: list[np.ndarray]  # per walk: int64 [len+1] base offsets
    lanes_of_vertex: Csr        # vertex -> flat lane-state ids (h * P + p)
    lin_ref: bool               # no edges -> linear reference (ILP_index.cpp:57-60)

    @property
    def P(self) -> int:
        return self.walk_mat.shape[1]

    @property
    def n_edges(self) -> int:
        return len(self.edge_u)

    def walk_seq_codes(self, h: int) -> np.ndarray:
        """Concatenated base codes of walk h (ILP_index.cpp:363-366)."""
        g = self.gfa
        walk = self.walk_mat[h, :self.walk_len[h]]
        return walk_codes_native(g.seq_code, g.node_off, walk)

    def path_seq(self, vertices: np.ndarray) -> str:
        g = self.gfa
        parts = [g.seq_code[g.node_off[v]:g.node_off[v + 1]] for v in vertices]
        return decode_seq(np.concatenate(parts)) if parts else ""


def tensorize(gfa: GfaData) -> PangenomeGraph:
    n_vtx = gfa.n_vtx
    edge_u, edge_v = gfa.edge_u, gfa.edge_v
    out_adj = build_csr(edge_u, edge_v, n_vtx)
    in_adj = build_csr(edge_v, edge_u, n_vtx)
    topo_order = toposort_native(n_vtx, edge_u, edge_v)
    topo_rank = np.zeros(n_vtx, dtype=np.int32)
    topo_rank[topo_order] = np.arange(n_vtx, dtype=np.int32)

    H = len(gfa.walks)
    P = max((len(w) for w in gfa.walks), default=0)
    walk_mat = np.full((H, P), -1, dtype=np.int32)
    walk_len = np.zeros(H, dtype=np.int32)
    cumlens: list[np.ndarray] = []
    for h, w in enumerate(gfa.walks):
        walk_mat[h, :len(w)] = w
        walk_len[h] = len(w)
        cl = np.zeros(len(w) + 1, dtype=np.int64)
        np.cumsum(gfa.node_len[w], out=cl[1:])
        cumlens.append(cl)

    # vertex -> flat lane states (h * P + p), by a native counting sort
    lanes_of_vertex = Csr(*lane_csr_native(walk_mat, walk_len, n_vtx))

    return PangenomeGraph(
        gfa=gfa, n_vtx=n_vtx, edge_u=edge_u, edge_v=edge_v,
        out_adj=out_adj, in_adj=in_adj,
        topo_order=topo_order, topo_rank=topo_rank,
        num_walks=H, walk_names=list(gfa.walk_names),
        walk_mat=walk_mat, walk_len=walk_len, walk_node_cumlen=cumlens,
        lanes_of_vertex=lanes_of_vertex, lin_ref=(len(edge_u) == 0),
    )


_panel_lock = threading.Lock()
# one slot (file key, PangenomeGraph): the latest panel a run loaded
_PANEL: dict = {}
# slot hits, graphs loaded into it and graphs dropped from it since the
# process started
PANEL_CACHE_STATS = {"hits": 0, "loads": 0, "drops": 0}


def panel_key(path: str) -> tuple | None:
    """The identity of the file at `path`: its real path, device, inode,
    size and modification time in ns, from one stat. None where it is no
    regular file that can be stat'ed (a pipe; a missing file, which the
    parser then reports), so that nothing is held for it."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    if not stat.S_ISREG(st.st_mode):
        return None
    return (os.path.realpath(path), st.st_dev, st.st_ino, st.st_size,
            st.st_mtime_ns)


def held_panel(key: tuple | None) -> PangenomeGraph | None:
    """The held graph where `key` is its file's; otherwise None, and the
    slot drops the graph it held, before the caller loads the new one."""
    with _panel_lock:
        slot = _PANEL.get("slot")
        if slot is not None and key is not None and slot[0] == key:
            PANEL_CACHE_STATS["hits"] += 1
            return slot[1]
        _drop_panel()
    return None


def hold_panel(key: tuple | None, graph: PangenomeGraph) -> None:
    """Hold a newly loaded graph under its file's key (nothing for None)."""
    if key is None:
        return
    with _panel_lock:
        _drop_panel()
        _PANEL["slot"] = (key, graph)
        PANEL_CACHE_STATS["loads"] += 1


def clear_panel() -> None:
    """Drop the held graph."""
    with _panel_lock:
        _drop_panel()


def _drop_panel() -> None:
    if _PANEL.pop("slot", None) is not None:
        PANEL_CACHE_STATS["drops"] += 1
