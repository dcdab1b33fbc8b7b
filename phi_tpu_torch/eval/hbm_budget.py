"""The port's device memory model: the bytes of the arrays the port
allocates on one device for an instance, at their real dtypes (the
counterpart of `phi_tpu/eval/hbm_budget.py`, whose rows are the JAX
package's arrays).

Two stages hold the device's memory, one after the other:
  anchors  the hit buffers (se, id, hap: 3x int64 x CAP, CAP from the
           walks' windows), the read spectrum's probe table, walk_mat
           and the two prefix-hash tables (int64), the per-k-mer
           accumulators of the threshold filter (5x int64 [spectrum]), one
           filter chunk's temporaries and the retained occurrence columns;
           with more than anchors.device.MAX_HAPS walks the pipeline takes
           the hit path instead (sketch.kernels.join_many), whose hits go
           back to the host batch by batch, so the stage holds only the
           mixed-bucket probe table, the join's batches in flight (each
           one's packed codes and hit columns) and one batch's join
           temporaries: no hit buffers, walk hashes or filter;
  solve    S, B, M (f32 [H, P]), the sweep's working set, W (f32 [L, H, P])
           or the streamed scratch, the switch sources and the state
           tables (int64), and the occurrence columns.
Both stages also count what the graph's memo (graph.pangenome) keeps on
the device from one run to the next: the packed batches (the run's, where
they are at most BATCHES_MAX_BYTES, on either route: on the hit path the
batches in flight are then the memo's, so their codes count twice), the
solver's switch sources and lane tables at any size, in the anchors stage
(the solve stage counts them as its own), and walk_mat and its prefix
hashes, which the memo keeps past the anchors stage where walk_mat is at
most WALK_HASHES_MAX_BYTES, in the solve stage (one device: a mesh run
takes the host hit path and keeps no statics).
A stage's bytes are the sum of its rows, some of which are not alive at
once (the filter's chunk temporaries end before its retained columns are
written), so they bound its peak from above; the total is the larger
stage. The solver rows divide over a mesh tile
(sp_shards x hap_shards) as the JAX model's do: P / sp_shards plus an L
column halo, H / hap_shards.

    python -m phi_tpu_torch.eval.hbm_budget --H 49 --P 1560000 --L 16 \\
        --spectrum 4000000 --occ 60000000 --hits 120000000 \\
        --windows 2250000000
"""

from __future__ import annotations

import argparse
import json
import sys

# Bytes per [H, P] lane (and per other extent) alive at a solve's peak,
# read off the tensors solve.dp.solve_exact holds there (the tests measure
# them on the CPU):
#   the sweep: the masks valid and has_vtx (bool), the int64 vertex clip,
#     and D, e_state, A, the cummin values, Mn and Apad (f32): 34 B a lane,
#     plus the column index (int64 [P]), Apad's and pad's L columns and
#     the entry minima (f32 [n_vtx]);
#   W materialized: the stack, and a layer step's difference and minimum
#     (f32: 8 B a lane);
#   W streamed: one layer's scatter target (f32 [H*P + L + 2]), and per
#     occurrence its selected weights (f32) and two int64 index columns.
SWEEP_LANE_BYTES = 34
LAYER_STEP_LANE_BYTES = 8
STREAM_OCC_BYTES = 20
# int64 [chunk] columns alive at the peak of a filter chunk's first pass
# (anchors.device._group_hashes and _kmer_stats)
FIN_COLUMNS = 12
# Bytes per window lane alive at the peak of one hit-path batch
# (sketch.kernels.join_rows), in compact_emitted's second gather: the rows
# kernel's key, pos and emit planes (int64, int32, bool: 13 B), and
# compact_emitted's order, dst and the position column widened to int64
# (24 B); beside them the unpacked codes (uint8, 1 B a row lane) and the
# two gathered [R, emitcap + 1] int64 columns.
JOIN_LANE_BYTES = 37


def spectrum_table_bytes(spectrum: int) -> int:
    """The read spectrum's probe table on the device: the cuckoo table
    (int64 key and id per slot, a power of two >= 2 keys per slot) up to
    CUCKOO_MAX_KEYS keys, else the mixed-key table (int64 m, lo, perm per
    key and its bucket offsets)."""
    from phi_tpu_torch.ops.search import CUCKOO_MAX_KEYS
    if spectrum <= CUCKOO_MAX_KEYS:
        return 2 * 8 * (1 << max(10, (2 * spectrum - 1).bit_length()))
    return mixed_table_bytes(spectrum)


def mixed_table_bytes(spectrum: int) -> int:
    """The mixed-key table (ops.search.mixed_tensors): int64 m, lo and
    perm per key, and the 2^bits + 1 bucket offsets."""
    from phi_tpu_torch.ops.search import mixed_bits_for
    return 3 * 8 * spectrum + 8 * ((1 << mixed_bits_for(spectrum)) + 1)


def hit_path_rows(spectrum: int, w: int) -> dict:
    """The anchors stage of the hit path (join_many's batches of ROWS rows
    of SUPER_BLOCKS blocks, read when called): the probe table, the WINDOW + 1 batches a join holds (the one being
    launched and those not yet harvested: int32 packed codes, nvalid and
    left; int64 n_min and n_hit, and the [cap_total + 1] position and id
    columns), and one batch's join temporaries at their peak. The two
    batch rows count the launched batch's hit columns twice, so they
    bound the join's peak from above by those."""
    from phi_tpu_torch.sketch import kernels as tk
    R, SB = tk.ROWS, tk.SUPER_BLOCKS
    row_lanes = (SB + 1) * tk.BLK
    held = row_lanes // 4 * R + 4 * 2 * R + 8 * 2 * R \
        + 2 * 8 * (tk.hit_cap(w, SB, R) + 1)
    return {
        "spectrum probe table (int64)": mixed_table_bytes(spectrum),
        "join batches in flight (WINDOW + 1: packed codes, hit columns)":
            (tk.WINDOW + 1) * held,
        "one batch's join temporaries (kernel planes, compaction)":
            row_lanes * R + JOIN_LANE_BYTES * SB * tk.BLK * R
            + 2 * 8 * R * (tk.emit_cap(w, SB) + 1),
    }


def walk_windows(walk_bases, k: int, w: int) -> int:
    """The windows the join reads: walk length in bases less the halo
    k + w - 2, over the walks at least one window long."""
    halo = k + w - 2
    return sum(n - halo for n in map(int, walk_bases) if n >= halo + 1)


def solve_bytes(H: int, P: int, L: int, n_occ: int, stream_w: bool,
                n_vtx: int | None = None) -> int:
    """Bytes a solve allocates beyond the solver statics and occurrence
    columns: S, B and M, the sweep's working set and W or its streamed
    scratch (the rows solve.dp.stream_w weighs against the free memory)."""
    rows = _solve_rows(H, P, L, n_occ, stream_w, n_vtx or P)
    return sum(v for k, v in rows.items() if not k.startswith(("switch",
                                                                "occ")))


def _solve_rows(H: int, P: int, L: int, n_occ: int, stream_w: bool,
                n_vtx: int, n_esrc: int | None = None) -> dict:
    lanes = H * P
    rows = {
        "S/B/M lane tables (3x f32 [H,P])": 3 * 4 * lanes,
        "sweep working set (masks, vertex clip, D, e_state, A, scan, Mn, "
        "Apad)": SWEEP_LANE_BYTES * lanes + 8 * P + 2 * 4 * H * L
        + 4 * n_vtx,
    }
    if stream_w:
        rows["W streamed scratch (a layer's f32 scatter target, 20 B per "
             "occurrence)"] = 4 * (lanes + L + 2) + STREAM_OCC_BYTES * n_occ
    else:
        rows["W straddle stack (f32 [L,H,P]) and a layer step"] = \
            (4 * L + LAYER_STEP_LANE_BYTES) * lanes
    if n_esrc is not None:
        rows["switch sources and state tables (int64 esrc h/p/target, "
             "state_vertex, walk_len)"] = 3 * 8 * n_esrc + 8 * lanes + 8 * H
    return rows


def budget(H: int, P: int, L: int, spectrum: int, n_occ: int, n_hits: int,
           *, windows: int, w: int = 25, n_vtx: int | None = None,
           n_esrc: int | None = None, chunk: int | None = None,
           sp_shards: int = 1, hap_shards: int = 1,
           stream_w: bool | None = None,
           capacity: int | None = None, pack_slot: int = 0) -> dict:
    """Per-device bytes of one (sp_shards x hap_shards) mesh tile, by row
    and stage. windows: the walks' windows (walk_windows); n_esrc: switch
    sources (default one per 16 lanes, the JAX model's); chunk: the
    filter's chunk (default anchors.device.fin_chunk()); with H above
    anchors.device.MAX_HAPS the anchors stage is the hit path's
    (hit_path_rows), whose occurrence columns reach the device only in
    the solve; stream_w: the
    streamed solve, or None for the solver's rule against `capacity` less
    what the solve finds allocated; capacity: the device's bytes (default
    the first card's total memory; None on a machine without one);
    pack_slot: the bytes of the run's batches the graph keeps (0 above
    BATCHES_MAX_BYTES)."""
    from phi_tpu_torch.anchors.device import (MAX_HAPS, fin_chunk,
                                              hit_buffer_len)
    from phi_tpu_torch.graph.pangenome import WALK_HASHES_MAX_BYTES
    n_vtx = n_vtx if n_vtx is not None else P
    n_esrc = n_esrc if n_esrc is not None else H * max(1, P // 16)
    ch = max(1, min(chunk if chunk is not None else fin_chunk(), n_hits))
    if capacity is None:
        import torch
        if torch.cuda.is_available():
            capacity = torch.cuda.get_device_properties(0).total_memory
    Pd = -(-P // sp_shards) + (L if sp_shards > 1 else 0)
    Hd = -(-H // hap_shards)
    occ_cols = ("occurrence columns (int64 s/span/id/hap, f32 weight)",
                (4 * 8 + 4) * n_occ)
    hit_path = H > MAX_HAPS
    anchors = hit_path_rows(spectrum, w) if hit_path else {
        "hit buffers (3x int64 x CAP)": 3 * 8 * hit_buffer_len(windows, w),
        "spectrum probe table (int64)": spectrum_table_bytes(spectrum),
        "walk_mat and prefix hashes (int64 [H,P], 2x [H,P+1])":
            8 * H * P + 2 * 8 * H * (P + 1),
        "filter accumulators (5x int64 [spectrum])": 5 * 8 * spectrum,
        "filter chunk temporaries (int64 [chunk] columns)":
            FIN_COLUMNS * 8 * ch,
        occ_cols[0]: occ_cols[1],
    }
    one_device = sp_shards == hap_shards == 1
    slot_row = ("packed batches held by the graph (<= BATCHES_MAX_BYTES)",
                pack_slot)
    anchors[slot_row[0]] = slot_row[1]
    anchors["held by the graph: switch sources and lane tables"] = \
        3 * 8 * n_esrc + 8 * H * P + 8 * H if one_device else 0
    wm_row = ("held by the graph: walk_mat and prefix hashes (walk_mat <= "
              "WALK_HASHES_MAX_BYTES)",
              8 * H * P + 2 * 8 * H * (P + 1)
              if one_device and not hit_path
              and 4 * H * P <= WALK_HASHES_MAX_BYTES else 0)
    if stream_w is None:
        held = occ_cols[1] + 3 * 8 * n_esrc + 8 * Hd * Pd + 8 * Hd \
            + slot_row[1] + wm_row[1]
        stream_w = capacity is not None and held + solve_bytes(
            Hd, Pd, L, n_occ, False, n_vtx) > capacity
    solve = _solve_rows(Hd, Pd, L, n_occ, stream_w, n_vtx, n_esrc)
    solve[occ_cols[0]] = occ_cols[1]
    solve[slot_row[0]] = slot_row[1]
    solve[wm_row[0]] = wm_row[1]
    stages = {"anchors": sum(anchors.values()),
              "solve": sum(solve.values())}
    total = max(stages.values())
    return {"per_device_bytes": {"anchors": anchors, "solve": solve},
            "stage_bytes": stages, "total_bytes": total,
            "total_gb": round(total / 1e9, 2), "stream_w": stream_w,
            "capacity_bytes": capacity,
            "fits": None if capacity is None else total <= capacity,
            "mesh": f"sp={sp_shards} x hap={hap_shards}",
            "sp_shards": sp_shards, "hap_shards": hap_shards,
            "dims": {"H": H, "P": P, "L": L, "P_per_device": Pd,
                     "H_per_device": Hd, "filter_chunk": ch}}


def budget_of_run(result, k: int, w: int, capacity: int | None = None
                  ) -> dict:
    """budget() at the shapes of one run of run_pipeline (a
    PipelineResult) on the device anchors or the hit path: its graph,
    spectrum, hits, retained occurrences, chunk, the solver's layers and
    the bytes of the packed batches the graph keeps (the device anchors'
    from the run, the hit path's as the graph holds them now)."""
    from phi_tpu_torch.solve.prep import (_bucket_layers, solver_layers,
                                          switch_sources_cached)
    g, a = result.graph, result.anchors
    occ = a.device_occ
    if occ is not None:
        n_occ, n_hits, pack = occ.n_occ, occ.n_hits, occ.pack_bytes
        max_span = occ.max_span
    else:
        from phi_tpu_torch.sketch.kernels import batches_bytes
        n_occ, pack = len(a.occ_hap), batches_bytes(g.memo)
        n_hits = sum(len(h[1]) for h in result.hits)
        max_span = int((a.occ_end - a.occ_start).max()) if n_occ else 0
    L = solver_layers(g, k)
    if max_span > 0:
        L = min(L, _bucket_layers(max_span - 1))
    return budget(g.num_walks, int(g.walk_mat.shape[1]), L,
                  int(a.spectrum_size), n_occ, n_hits,
                  windows=walk_windows((c[-1] for c in g.walk_node_cumlen), k,
                                       w), w=w,
                  n_vtx=g.n_vtx, n_esrc=len(switch_sources_cached(g)[0]),
                  capacity=capacity, pack_slot=pack)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m phi_tpu_torch.eval.hbm_budget")
    ap.add_argument("--H", type=int, required=True)
    ap.add_argument("--P", type=int, required=True)
    ap.add_argument("--L", type=int, default=16)
    ap.add_argument("--spectrum", type=int, default=4_000_000)
    ap.add_argument("--occ", type=int, default=25_000_000)
    ap.add_argument("--hits", type=int, default=50_000_000)
    ap.add_argument("--windows", type=int, default=None,
                    help="windows the join reads [H x P x 30: 30 bp nodes]")
    ap.add_argument("-w", type=int, default=25)
    ap.add_argument("--esrc", type=int, default=None)
    ap.add_argument("--capacity-gb", type=float, default=None,
                    help="device memory in GB [the first card's, if any]")
    ap.add_argument("--stream-w", choices=["auto", "0", "1"], default="auto")
    ap.add_argument("--mesh", default="1",
                    help="comma list of sp-shard counts to tabulate")
    args = ap.parse_args(argv)
    windows = args.windows if args.windows is not None \
        else args.H * args.P * 30
    cap = None if args.capacity_gb is None else int(args.capacity_gb * 1e9)
    sw = None if args.stream_w == "auto" else args.stream_w == "1"
    for sp in [int(x) for x in args.mesh.split(",")]:
        print(json.dumps(budget(
            args.H, args.P, args.L, args.spectrum, args.occ, args.hits,
            windows=windows, w=args.w, n_esrc=args.esrc, sp_shards=sp,
            stream_w=sw, capacity=cap)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
