"""Progressive-panel subsetting: derive an N-haplotype graph from a larger
one, the reference's chop_graph.sh:37-69 workflow (vg gbwt ignore-lists +
gfa2gbwt rebuild) done natively. Kept walks define the subgraph: a segment
survives iff some kept walk visits it, an edge iff some kept walk traverses
it — exactly what a GBWT rebuilt from the kept haplotypes encodes. Used by
the increasing.csv-style scaling sweep (data/plots/increasing.csv axes).

The port's copy of `phi_tpu/io/subset.py`, on the port's `io.gfa`; host
only (no device). It writes the same GfaData with array operations where
the JAX package loops over walk steps and segments (at 48 walks of 5 Mbp,
8 million edge tuples).

    python -m phi_tpu_torch.io.subset -g graph.gfa -o sub.gfa -n 7
    python -m phi_tpu_torch.io.subset -g graph.gfa -o sub.gfa --keep A.0,B.1
"""

from __future__ import annotations

import sys

import numpy as np

from phi_tpu_torch.graph.pangenome import ragged_arange
from phi_tpu_torch.io.gfa import GfaData, read_gfa, write_gfa


def subset_panel(g: GfaData, keep: list[int]) -> GfaData:
    """GfaData restricted to the walks in `keep` (indices, order preserved)."""
    for i in keep:
        if not 0 <= i < len(g.walks):
            raise ValueError(f"walk index {i} out of range "
                             f"(graph has {len(g.walks)} walks)")
    used = np.zeros(g.n_vtx, bool)
    pairs = []
    for i in keep:
        w = g.walks[i].astype(np.int64)
        used[w] = True
        pairs.append(w[:-1] << 32 | w[1:])
    old_ids = np.flatnonzero(used)
    remap = np.full(g.n_vtx, -1, np.int32)
    remap[old_ids] = np.arange(len(old_ids), dtype=np.int32)

    node_len = g.node_len[old_ids]
    node_off = np.zeros(len(old_ids) + 1, np.int64)
    np.cumsum(node_len, out=node_off[1:])
    # the kept segments' codes, in order: one gather over their spans
    seq_code = g.seq_code[np.repeat(g.node_off[old_ids], node_len)
                          + ragged_arange(node_len)]

    # the traversed edges, each once, in (u, v) order; remap keeps the order
    edges = np.unique(np.concatenate(pairs)) if pairs else \
        np.zeros(0, np.int64)
    edge_u = remap[edges >> 32]
    edge_v = remap[edges & 0xFFFFFFFF]

    return GfaData(
        seg_names=[g.seg_names[int(v)] for v in old_ids],
        node_len=node_len, node_off=node_off, seq_code=seq_code,
        edge_u=edge_u, edge_v=edge_v,
        walks=[remap[g.walks[i]] for i in keep],
        walk_names=[g.walk_names[i] for i in keep],
        seg_tags=([g.seg_tags[int(v)] for v in old_ids]
                  if g.seg_tags else None),
        walk_meta=([g.walk_meta[i] for i in keep] if g.walk_meta else None),
    )


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="phi-torch-subset",
        description="Derive an N-haplotype panel subset of a GFA graph "
                    "(chop_graph.sh progressive-imputation panels, natively)")
    ap.add_argument("-g", dest="gfa", required=True, help="input GFA(.gz)")
    ap.add_argument("-o", dest="out", required=True, help="output GFA path")
    grp = ap.add_mutually_exclusive_group(required=True)
    grp.add_argument("-n", dest="n", type=int,
                     help="keep the first N walks")
    grp.add_argument("--keep", dest="keep",
                     help="comma list of walk names (sample.hap) to keep")
    args = ap.parse_args(argv)
    g = read_gfa(args.gfa)
    if args.n is not None:
        if args.n < 1 or args.n > len(g.walks):
            print(f"[E::main] -n must be in [1,{len(g.walks)}], got {args.n}",
                  file=sys.stderr)
            return 1
        keep = list(range(args.n))
    else:
        names = args.keep.split(",")
        by_name = {n: i for i, n in enumerate(g.walk_names)}
        missing = [n for n in names if n not in by_name]
        if missing:
            print(f"[E::main] walks not in graph: {','.join(missing)}",
                  file=sys.stderr)
            return 1
        keep = [by_name[n] for n in names]
    sub = subset_panel(g, keep)
    write_gfa(sub, path=args.out)
    print(f"[M::main] kept {len(keep)}/{len(g.walks)} walks, "
          f"{sub.n_vtx}/{g.n_vtx} segments, {len(sub.edge_u)} edges "
          f"-> {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
