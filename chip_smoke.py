#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (phi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  0. the native host library, then the card (nvidia-smi name and power
     limit) and the torch/CUDA versions; no CUDA device -> exit 1;
  1. build the rows3 CUDA kernel from phi_tpu_torch/csrc (into
     phi_tpu_torch/_build/);
  2. the kernel against its plain torch twin on the card at the production
     shape (R=8, SB=256, k=31, w=25, C=2048), plus (k, w) = (21, 11) and a
     cnt > C case: outputs array-equal; medians of 10 timed runs each;
  3. the whole path on a small instance (4 haplotypes x 200 kbp) on cuda
     and on cpu: byte-identical FASTA, same report, bound and objective;
  4. the main path at size (49 haplotypes x 5 Mbp, 30 bp nodes, 1x reads,
     -k 31 -w 25 -R 100), cold then warm, counting rows3 launches; the
     kernel against its twin on the instance's first two packed batches.
The second-to-last line is the kernels JSON, the last the device JSON.
Instances are generated from a seed into phi_tpu_torch/_build/scale/.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(ROOT, "phi_tpu_torch", "_build")


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def fail(msg: str) -> int:
    print(f"[smoke] FAILED: {msg}", flush=True)
    return 1


def cuda_ms(fn, reps: int = 10) -> float:
    """Median of `reps` CUDA-event timings of fn() (after one warm-up)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def rows3_inputs(seed: int, sb: int, rows: int = 8):
    """Random A/C/G/T rows with a random 1-30 bp node chop, on the card:
    full, partial, short and empty rows, with and without a left base."""
    import numpy as np
    import torch
    from phi_tpu_torch.sketch import kernels as tk
    rng = np.random.default_rng(seed)
    row_lanes = (sb + 1) * tk.BLK
    codes = rng.integers(0, 4, (rows, row_lanes), dtype=np.uint8)
    cap = row_lanes // 4
    starts = np.full((rows, cap), row_lanes, np.int32)
    for r in range(rows):
        off = np.cumsum(rng.integers(1, 31, cap))
        off = off[off < row_lanes]
        starts[r, :len(off)] = off
    full = sb * tk.BLK
    nvalid = np.array([full, full, full // 3, 5000, 0, full, 1, full - 77],
                      np.int32)[:rows]
    left = np.where(rng.random(rows) < 0.5, rng.integers(0, 4, rows), -1)
    dev = torch.device("cuda")
    nd = tk.delta_plane(torch.from_numpy(starts).to(dev), row_lanes)
    base = torch.from_numpy(rng.integers(0, 1000, rows).astype(np.int32)).to(dev)
    return (torch.from_numpy(codes).to(dev), nd,
            torch.from_numpy(nvalid).to(dev),
            torch.from_numpy(left.astype(np.int32)).to(dev),
            tk.block_node_offsets(nd, base, sb))


def compare_rows3(args, k: int, w: int, C: int) -> int:
    """Kernel vs twin on the same card tensors; returns the max abs error
    over (key, se, cnt) and raises if they differ."""
    import torch
    from phi_tpu_torch.sketch import kernels as tk
    want = tk.sketch_rows3_torch(*args, k, w, C)
    got = tk.sketch_rows3(*args, k, w, C)
    torch.cuda.synchronize()
    err = 0
    for name, a, b in zip(("key", "se", "cnt"), want, got):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"rows3 {name}: {b.dtype} {tuple(b.shape)}"
                                 f" vs twin {a.dtype} {tuple(a.shape)}")
        diff = (a.long() - b.long()).abs()
        err = max(err, int(diff.max()) if diff.numel() else 0)
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"rows3 {name} differs from the twin at "
                                 f"{bad} entries (k={k} w={w} C={C})")
    return err


def run_port(paths, out, argv, device):
    from phi_tpu_torch import cli
    from phi_tpu_torch.pipeline import run_pipeline
    opt = cli.options_from_args(cli.build_parser().parse_args(
        ["-g", paths["gfa"], "-r", paths["reads"], "-o", out] + argv))
    return run_pipeline(paths["gfa"], paths["reads"], out, opt, device=device)


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "phi_tpu_torch")):
        return fail("phi_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    os.environ.setdefault("PHI_TPU_SCALE_CACHE", os.path.join(BUILD, "scale"))
    # the run uses one card: show torch only the first visible one
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = \
        "0" if visible is None else visible.split(",")[0]

    # --- phase 0: the host library, the card ---
    import torch
    from phi_tpu_torch.pipeline import native_available
    log(f"native library available: {native_available()}")
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else ""
    if not card:
        return fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card, flush=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, devices {torch.cuda.device_count()}")
    if not native_available():
        return fail("native host library unavailable (make -C native)")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

    # --- phase 1: build ---
    from phi_tpu_torch.sketch import kernels as tk
    t0 = time.time()
    tk.build_rows3()
    log(f"rows3 CUDA kernel built in {time.time() - t0:.3f} s")

    # --- phase 2: kernel vs twin at the production shape ---
    sb = tk.SUPER_BLOCKS
    max_err = 0
    args = rows3_inputs(1, sb)
    C = tk.block_cap(25)
    max_err = max(max_err, compare_rows3(args, 31, 25, C))
    ms = cuda_ms(lambda: tk.sketch_rows3(*args, 31, 25, C))
    plain_ms = cuda_ms(lambda: tk.sketch_rows3_torch(*args, 31, 25, C))
    log(f"rows3 k=31 w=25 R=8 SB={sb} C={C}: equal to twin; kernel "
        f"{ms:.4f} ms, twin {plain_ms:.4f} ms (median of 10, {card})")
    args = rows3_inputs(2, sb)
    max_err = max(max_err, compare_rows3(args, 21, 11, tk.block_cap(11)))
    max_err = max(max_err, compare_rows3(args, 21, 11, 256))
    cnt = tk.sketch_rows3(*args, 21, 11, 256)[2]
    if not bool((cnt > 256).any()):
        return fail("the cnt > C case did not overflow C")
    log(f"rows3 k=21 w=11 (C={tk.block_cap(11)} and C=256, max cnt "
        f"{int(cnt.max())}): equal to twin")

    # --- phase 3: small instance, cuda against cpu ---
    from phi_tpu_torch.eval import build_instance, edit_stats
    small = build_instance(4, 200_000, coverage=2.0)
    res = {}
    for d in ("cuda", "cpu"):
        out = os.path.join(os.path.dirname(small["gfa"]), f"port_{d}.fa")
        res[d] = (run_port(small, out, [], torch.device(d)), out)
    (rc, oc), (rp, op) = res["cuda"], res["cpu"]
    with open(oc, "rb") as a, open(op, "rb") as b:
        if a.read() != b.read():
            return fail("small instance: FASTA differs between cuda and cpu")
    if (rc.report_segments != rp.report_segments
            or rc.recombination_count != rp.recombination_count
            or abs(rc.decode.dp_objective - rp.decode.dp_objective) > 1e-3
            or abs(rc.decode.true_objective - rp.decode.true_objective) > 1e-3):
        return fail("small instance: report, bound or objective differs")
    log(f"small 4x200kbp: cuda == cpu (FASTA bytes, {rc.recombination_count}"
        f" recombinations, bound {rc.decode.dp_objective:.3f}, objective "
        f"{rc.decode.true_objective:.3f})")

    # --- phase 4: the main path at size ---
    t0 = time.time()
    big = build_instance(49, 5_000_000, coverage=1.0)
    log(f"instance 49 x 5 Mbp, 1x: ready in {time.time() - t0:.1f} s")
    with open(big["truth"]) as f:
        truth = "".join(ln.strip() for ln in f if not ln.startswith(">"))
    flags = ["-k", "31", "-w", "25", "-R", "100"]
    launches = None
    for run in ("cold", "warm"):
        out = os.path.join(os.path.dirname(big["gfa"]), f"port_{run}.fa")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tk.sketch_rows3.launches = 0
        t0 = time.time()
        r = run_port(big, out, flags, dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        n_launch = tk.sketch_rows3.launches
        if launches is None:
            launches = n_launch
        occ_dev = r.anchors.device_occ.dev_s.device
        gap = max(0.0, r.decode.true_objective - r.decode.dp_objective)
        from phi_tpu_torch.pipeline import gap_tol
        es = edit_stats(r.sequence, truth)
        log(f"{run}: wall {wall:.3f} s; timings "
            + json.dumps({k: round(v, 4) for k, v in r.timings.items()}))
        log(f"{run}: peak device memory {torch.cuda.max_memory_allocated()}"
            f" B; rows3 launches {n_launch}; anchors on {occ_dev}; solver on"
            f" {r.decode.solver_device}; gap {gap:.3f} (certified "
            f"{gap <= gap_tol(100.0)}); recombinations "
            f"{r.recombination_count}; edit distance to truth "
            f"{es.edit_distance} (identity {es.identity:.6f})")
        if n_launch <= 0:
            return fail("the main path launched no rows3 kernel")
        if occ_dev.type != "cuda" or not r.decode.solver_device.startswith(
                "cuda"):
            return fail("anchor or solver tensors are not on cuda")

    # the kernel against its twin on the instance's own first batches
    from phi_tpu_torch import state
    from phi_tpu_torch.anchors.device import (_row_start_cap, pack_batch,
                                              plan_rows)
    g = r.graph
    seqs = [g.walk_seq_codes(h) for h in range(g.num_walks)]
    row_lanes = (sb + 1) * tk.BLK
    rows = plan_rows(seqs, 31, 25, sb)
    S_cap = _row_start_cap(g.walk_node_cumlen, rows, row_lanes)
    for b in range(2):
        batch = rows[b * tk.ROWS:(b + 1) * tk.ROWS]
        words, starts, nv, left, base, _ = state.batch_tensors(
            *pack_batch(seqs, g.walk_node_cumlen, batch, row_lanes, S_cap),
            dev)
        nd = tk.delta_plane(starts, row_lanes)
        args = (tk.unpack_2bit(words, row_lanes), nd, nv, left,
                tk.block_node_offsets(nd, base, sb))
        max_err = max(max_err, compare_rows3(args, 31, 25, C))
    log("rows3 equal to twin on the 49 x 5 Mbp instance's first 2 batches")

    print(json.dumps({"kernels": [{
        "name": "rows3", "route": "cuda",
        "source": "phi_tpu_torch/csrc/rows3.cu",
        "replaces": "phi_tpu/sketch/kernels.py:1000",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
