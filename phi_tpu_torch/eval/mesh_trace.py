"""Measured mesh: the port's counterpart of `phi_tpu/eval/mesh_trace.py`.

On one eval/scale instance it measures what the sharded exact solve's
collectives move, and the mesh's walls:

  1. per device and per sweep, the calls, output bytes and moved bytes of
     each collective kind, counted over the helpers' executed calls
     (parallel.sharded.count_collectives), with the setup and end terms
     apart and the host syncs the solver waits on;
  2. the sharded solve's wall beside the single-device solve_dp's on the
     same tables, and, unless skip_e2e, the pipeline's wall on one device
     and on the mesh, with the two FASTAs compared byte for byte.

The port compiles no program, so there is no HLO to read: the JAX tool's
collective_bytes_from_hlo has no counterpart. With one card the shards
lie on cuda:0; with N cards, one a card.

    python -m phi_tpu_torch.eval.mesh_trace --haps 49 --length 46000000 \\
        --coverage 2 --out bench_results/comm_volume_torch --skip-e2e
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def mesh_devices(n: int, device) -> list:
    """n shards of `device`'s type: one a card, round-robin over the
    visible cards (all on cuda:0 with one card); n CPU shards on the
    CPU."""
    import torch
    if device.type == "cpu":
        return [device] * n
    n_vis = torch.cuda.device_count()
    return [torch.device("cuda", i % n_vis) for i in range(n)]


def sweep_closed_form(n_vtx: int, Hs: int, L: int, n_hap: int,
                      n_sp: int) -> dict:
    """Per device, one executed exact-credit sweep (L <= Ps, n_sp >= 2) and
    its convergence vote, as the port's helpers run them over G = n_hap x
    n_sp shards: all-reduce, the [n_vtx] f32 entry minimum (one reduction
    over hap x sp) and the 1-byte bool vote; all-gather, the [n_sp, Hs]
    f32 sp totals; collective-permute, two [Hs, L] f32 halos. Moved bytes
    are each shard's mean: a reduction onto the first shard and back moves
    2 (G - 1) / G of its tensor, the vote (G - 1) / G of its flag, the
    gather n_sp - 1 parts, a halo (n_sp - 1) / n_sp."""
    G = n_hap * n_sp
    entry, totals, halo = 4 * n_vtx, 4 * Hs, 4 * Hs * L
    return {"calls": {"all-reduce": 2, "all-gather": 1,
                      "collective-permute": 2},
            "out_bytes": {"all-reduce": entry + 1,
                          "all-gather": n_sp * totals,
                          "collective-permute": 2 * halo},
            "moved_bytes": {"all-reduce": (2 * entry + 1) * (G - 1) / G,
                            "all-gather": (n_sp - 1) * totals,
                            "collective-permute":
                                2 * halo * (n_sp - 1) / n_sp}}


def _add(a: dict, b: dict) -> dict:
    return {f: {k: a[f][k] + b[f][k] for k in a[f]}
            for f in ("calls", "out_bytes", "moved_bytes")}


def _per_device(rec: dict, shards: int) -> dict:
    return {f: {k: v / shards for k, v in rec[f].items()}
            for f in ("calls", "out_bytes", "moved_bytes")}


def summarize(count, shards: int) -> dict:
    """The record's `collectives` from one solve's CollectiveCount over
    `shards` hap x sp shards: per device, one sweep (each executed sweep
    counts the same, and so does each vote: `uniform`) with its vote, and
    the setup and end terms; the host syncs per sweep and at the end; the
    host seconds in each kind of scope (the sweeps' is their queueing, the
    votes' the wait for the device)."""
    sweeps, votes = count.records("sweep"), count.records("vote")
    setup, end = count.records("setup"), count.records("end")
    uniform = all(r == sweeps[0] for r in sweeps) and all(
        r == votes[0] for r in votes)
    one = _add(sweeps[0], votes[0]) if votes else sweeps[0]
    return {
        "shards": shards,
        "per_sweep": _per_device(one, shards),
        "setup": _per_device(setup[0], shards),
        "end": _per_device(end[0], shards),
        "host_syncs_per_sweep": sweeps[0]["host_syncs"]
        + (votes[0]["host_syncs"] if votes else 0),
        "host_syncs_end": end[0]["host_syncs"],
        "sweeps_counted": len(sweeps), "votes_counted": len(votes),
        "uniform": uniform,
        "wall_s": {"setup": count.wall_s("setup"),
                   "sweeps": count.wall_s("sweep"),
                   "votes": count.wall_s("vote"), "end": count.wall_s("end")},
    }


def _tables(paths: dict, opt, device):
    """The instance's solver tables (graph, reads, -k, -w, -R of `opt`), as
    run_pipeline builds them for its first solve on one device: the device
    anchors, or the hit path where they hand over."""
    from phi_tpu_torch import pipeline
    from phi_tpu_torch.anchors.join import (AnchorTables,
                                            anchor_tables_from_hits)
    from phi_tpu_torch.graph.pangenome import tensorize
    from phi_tpu_torch.io.gfa import read_gfa
    from phi_tpu_torch.io.reads import load_read_batch
    from phi_tpu_torch.solve.prep import build_solver_tables, solver_layers
    graph = tensorize(read_gfa(paths["gfa"]))
    spectrum = pipeline.read_spectrum(load_read_batch(paths["reads"]),
                                      opt.k, opt.w)
    codes = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    dres = pipeline.join_anchors_device(graph, codes, opt.k, opt.w,
                                        *spectrum, opt.threshold,
                                        device=device)
    if dres is None:
        hits = pipeline._join_hits(graph, codes, opt, spectrum, device)
        anchors = anchor_tables_from_hits(graph, opt.k, hits,
                                          len(spectrum[0]), opt.threshold)
    else:
        anchors = AnchorTables.on_device(*dres, len(spectrum[0]))
    return build_solver_tables(graph, anchors, opt.recombination,
                               solver_layers(graph, opt.k))


def _synced(devices, fn):
    """(fn(), its wall s), every card of `devices` synchronized around
    it."""
    import torch
    cards = {d for d in devices if d.type == "cuda"}
    for d in cards:
        torch.cuda.synchronize(d)
    t0 = time.time()
    out = fn()
    for d in cards:
        torch.cuda.synchronize(d)
    return out, time.time() - t0


def run(n_haps: int, length: int, coverage: float, seed: int,
        skip_e2e: bool = False, device="cuda", shards: int | None = None
        ) -> dict:
    import torch

    from phi_tpu_torch import pipeline
    from phi_tpu_torch.config import Options
    from phi_tpu_torch.eval.scale import build_instance
    from phi_tpu_torch.parallel import sharded
    from phi_tpu_torch.solve.dp import solve_dp
    from phi_tpu_torch.trace import card_line

    device = pipeline.resolve_device(device)
    if shards is None:
        shards = max(2, torch.cuda.device_count()
                     if device.type == "cuda" else 0)
    paths = build_instance(n_haps, length, coverage, seed)
    mesh = sharded.make_mesh(shards, devices=mesh_devices(shards, device))
    every = [device, *mesh.flat]
    opt = Options(lagrangian_rounds=2)

    # single-device and mesh end-to-end walls (same process, same host)
    wall_single = wall_mesh = identical = None
    if not skip_e2e:
        out = os.path.join(os.path.dirname(paths["gfa"]), "mesh_out")
        _, wall_single = _synced(every, lambda: pipeline.run_pipeline(
            paths["gfa"], paths["reads"], out + ".1.fa", opt,
            device=device))
        _, wall_mesh = _synced(every, lambda: pipeline.run_pipeline(
            paths["gfa"], paths["reads"], out + f".{shards}.fa", opt,
            device=device, mesh=mesh))
        with open(out + ".1.fa", "rb") as a, \
                open(out + f".{shards}.fa", "rb") as b:
            identical = a.read() == b.read()

    # the sharded exact solve on solve_dp_sharded's inputs: once to warm,
    # once counted; then solve_dp on the same tables, warm
    tables = _tables(paths, opt, device)
    if tables.n_layers is None:
        raise ValueError("the instance's tables take bracket mode: no "
                         "exact-credit solve to measure")
    args, _ = sharded.exact_solver_args(tables, mesh)
    solve = sharded.sharded_solve_exact(
        mesh, R=tables.R, n_vtx=tables.n_vtx, n_layers=tables.n_layers,
        max_sweeps=opt.max_sweeps)
    M0, end0, sweeps0 = solve(*args)
    with sharded.count_collectives() as count:
        (M, end_min, n_sweeps), solve_wall_mesh = _synced(
            every, lambda: solve(*args))
    del args
    solve_dp(tables, opt.max_sweeps, device)
    (sol, ends, sweeps1, _), solve_wall_single = _synced(
        every, lambda: solve_dp(tables, opt.max_sweeps, device))
    H, P = tables.state_vertex.shape
    same_single = (torch.equal(M[:H, :P].to(sol.M.device), sol.M)
                   and end_min == float(ends.min()) and n_sweeps == sweeps1)
    same_counted = (torch.equal(M, M0) and end_min == end0
                    and n_sweeps == sweeps0)

    grid = mesh.shape["hap"] * mesh.shape["sp"]
    comm = summarize(count, grid)
    Hs, Ps = M.shape[0] // mesh.shape["hap"], M.shape[1] // mesh.shape["sp"]
    closed = (sweep_closed_form(tables.n_vtx, Hs, tables.n_layers,
                                mesh.shape["hap"], mesh.shape["sp"])
              if tables.n_layers <= Ps and mesh.shape["sp"] > 1 else None)
    return {
        "data": "synthetic",
        "backend": "gpu" if device.type == "cuda" else "cpu",
        "device": (card_line() or torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "n_devices": shards,
        "mesh": {"dp": mesh.shape["dp"], "hap": mesh.shape["hap"],
                 "sp": mesh.shape["sp"],
                 "devices": sorted({str(d) for d in mesh.flat})},
        "n_haps": n_haps, "length": length, "coverage": coverage,
        "seed": seed,
        "byte_identical_mesh_vs_single": identical,
        "wall_single_s": wall_single,
        "wall_mesh_s": wall_mesh,
        "solve_wall_mesh_s": solve_wall_mesh,
        "solve_wall_single_s": solve_wall_single,
        "solve_bit_equal_mesh_vs_single": same_single,
        "solve_bit_equal_counted_vs_not": same_counted,
        "n_sweeps": n_sweeps,
        "n_vtx": tables.n_vtx, "n_layers": tables.n_layers,
        "block": [Hs, Ps],
        "collectives": comm,
        "closed_form_per_sweep": closed,
        "per_sweep_mb_per_device":
            sum(comm["per_sweep"]["out_bytes"].values()) / 1e6,
        "note": "collective bytes are counted over the helpers' EXECUTED "
                "calls in one counted solve (parallel.sharded."
                "count_collectives), not over a compiled program's "
                "instructions: per device is the mean over the hap x sp "
                "shards; per_sweep is one executed sweep and the "
                "convergence vote that tests it. out_bytes is each "
                "shard's output (the JAX tool's HLO output shape; the "
                "port's entry minimum is one reduction over hap x sp "
                "where the JAX program runs two, over sp then hap); "
                "moved_bytes is what one shard index hands another, even "
                "on one card, through a reduction onto the first shard "
                "and a broadcast back. The inputs' split to the shards "
                "and M's gather are not collectives of the solve. Walls "
                "are host clocks around a synchronized device; shards "
                "that share a card run one after another.",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="phi-torch-mesh-trace")
    ap.add_argument("--haps", type=int, default=49)
    ap.add_argument("--length", type=int, default=46_000_000)
    ap.add_argument("--coverage", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="bench_results/comm_volume_torch")
    ap.add_argument("--skip-e2e", action="store_true",
                    help="collective bytes + solve walls only (no "
                         "end-to-end pipeline runs)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="torch device of the shards [cuda]")
    ap.add_argument("--mesh", type=int, default=None,
                    help="shard count [the number of cards, at least 2]")
    args = ap.parse_args(argv)
    try:
        rec = run(args.haps, args.length, args.coverage, args.seed,
                  skip_e2e=args.skip_e2e, device=args.device,
                  shards=args.mesh)
    except (ValueError, OSError, RuntimeError) as e:
        # a missing CUDA device and failed runs end as [E::main], exit 1
        sys.stderr.write(f"[E::main] {e}\n")
        return 1
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out + ".json", "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
