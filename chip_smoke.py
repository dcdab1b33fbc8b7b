#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (phi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  0. the native host library, then the card (nvidia-smi name and power
     limit) and the torch/CUDA versions; no CUDA device -> exit 1;
  1. build the rows kernel family (rows3, rows3w, rows2) from
     phi_tpu_torch/csrc/rows.cu (into phi_tpu_torch/_build/);
  2. each kernel against its plain torch twin on the card at the production
     shape (R=8, SB=256): rows3 at k=31 w=25 C=2048, plus (k, w) = (21, 11)
     and a cnt > C case; rows3w at k=35 w=25 and k=63 w=11; rows2 at k=31
     w=25: outputs array-equal; medians of 10 timed runs each;
  3. the whole path on a small instance (4 haplotypes x 200 kbp) on cuda
     and on cpu: byte-identical FASTA, same report, bound and objective;
  4. the main path at size (49 haplotypes x 5 Mbp, 30 bp nodes, 1x reads,
     -k 31 -w 25 -R 100), cold then warm, counting rows3 launches; the
     kernel against its twin on the instance's first two packed batches;
  5. wide k on the same instance (-k 35 -w 25 -R 100), cold then warm,
     through rows3w; certified;
  6. the v2 mixed route at chromosome length (4 haplotypes x 200 Mbp, 1x
     reads, -k 31 -w 25 -R 100): a read spectrum above the cuckoo table's
     8,000,000 keys, so rows2 runs and rows3 does not; certified; rows2
     against its twin on the instance's first two packed batches.
Phases 4-6 set every kernel's launch count to 0 just before each run and
read them just after. The second-to-last line is the kernels JSON, the
last the device JSON. Instances are generated from a seed into
phi_tpu_torch/_build/scale/.
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


def compare(name: str, args, *params) -> int:
    """Kernel `name` (rows3, rows3w or rows2) against its twin on the same
    card tensors; returns the max abs error over all outputs and raises if
    they differ."""
    import torch
    from phi_tpu_torch.sketch import kernels as tk
    want = getattr(tk, f"sketch_{name}_torch")(*args, *params)
    got = getattr(tk, f"sketch_{name}")(*args, *params)
    torch.cuda.synchronize()
    err = 0
    for i, (a, b) in enumerate(zip(want, got)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name} output {i}: {b.dtype} "
                                 f"{tuple(b.shape)} vs twin {a.dtype} "
                                 f"{tuple(a.shape)}")
        diff = (a.long() - b.long()).abs()
        err = max(err, int(diff.max()) if diff.numel() else 0)
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"{name} output {i} differs from the twin "
                                 f"at {bad} entries {params}")
    return err


def run_port(paths, out, argv, device):
    from phi_tpu_torch import cli
    from phi_tpu_torch.pipeline import run_pipeline
    opt = cli.options_from_args(cli.build_parser().parse_args(
        ["-g", paths["gfa"], "-r", paths["reads"], "-o", out] + argv))
    return run_pipeline(paths["gfa"], paths["reads"], out, opt, device=device)


KERNELS = ("rows3", "rows3w", "rows2")


def run_counted(paths, out, argv, dev):
    """One run of the pipeline on the card with every kernel's launch count
    set to 0 just before it; returns (result, wall s, launches by name,
    peak device memory B)."""
    import torch
    from phi_tpu_torch.sketch import kernels as tk
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for n in KERNELS:
        getattr(tk, f"sketch_{n}").launches = 0
    t0 = time.time()
    r = run_port(paths, out, argv, dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {n: getattr(tk, f"sketch_{n}").launches for n in KERNELS}
    return r, wall, launches, torch.cuda.max_memory_allocated()


def report(label: str, r, wall: float, launches, peak: int, truth: str,
           R: float) -> bool:
    """Log one run; returns whether it is certified."""
    from phi_tpu_torch.eval import edit_stats
    from phi_tpu_torch.pipeline import gap_tol
    gap = max(0.0, r.decode.true_objective - r.decode.dp_objective)
    es = edit_stats(r.sequence, truth)
    log(f"{label}: wall {wall:.3f} s; timings "
        + json.dumps({k: round(v, 4) for k, v in r.timings.items()}))
    log(f"{label}: peak device memory {peak} B; launches "
        f"{json.dumps(launches)}; spectrum {r.anchors.spectrum_size} keys; "
        f"{r.anchors.device_occ.n_hits} join hits, "
        f"{r.anchors.device_occ.n_occ} retained occurrences; "
        f"anchors on {r.anchors.device_occ.dev_s.device}; solver on "
        f"{r.decode.solver_device}; gap {gap:.3f} (certified "
        f"{gap <= gap_tol(R)}); recombinations {r.recombination_count}; "
        f"edit distance to truth {es.edit_distance} (identity "
        f"{es.identity:.6f})")
    return gap <= gap_tol(R)


def on_cuda(r) -> bool:
    return (r.anchors.device_occ.dev_s.device.type == "cuda"
            and r.decode.solver_device.startswith("cuda"))


def instance_batches(r, k: int, w: int, dev, v2: bool):
    """The kernel inputs of the first two packed batches of a run's graph,
    packed as its route packs them (node starts for v3, the dense node
    plane for v2)."""
    from phi_tpu_torch import state
    from phi_tpu_torch.anchors.device import (_row_start_cap, pack_batch,
                                              plan_rows)
    from phi_tpu_torch.sketch import kernels as tk
    g = r.graph
    seqs = [g.walk_seq_codes(h) for h in range(g.num_walks)]
    sb = tk.SUPER_BLOCKS
    row_lanes = (sb + 1) * tk.BLK
    rows = plan_rows(seqs, k, w, sb)
    S_cap = None if v2 else _row_start_cap(g.walk_node_cumlen, rows,
                                           row_lanes)
    for b in range(2):
        batch = rows[b * tk.ROWS:(b + 1) * tk.ROWS]
        words, nodes, nv, left, base, _ = state.batch_tensors(
            *pack_batch(seqs, g.walk_node_cumlen, batch, row_lanes, S_cap),
            dev)
        nd = nodes if v2 else tk.delta_plane(nodes, row_lanes)
        yield (tk.unpack_2bit(words, row_lanes), nd, nv, left,
               tk.block_node_offsets(nd, base, sb))


def read_truth(paths) -> str:
    with open(paths["truth"]) as f:
        return "".join(ln.strip() for ln in f if not ln.startswith(">"))


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
    tk.build_rows()
    log(f"rows kernels (rows3, rows3w, rows2) built in {time.time() - t0:.3f}"
        f" s")

    # --- phase 2: each kernel vs its twin at the production shape ---
    sb = tk.SUPER_BLOCKS
    err = dict.fromkeys(KERNELS, 0)
    ms, plain_ms = {}, {}

    def check(name, args, *params):
        err[name] = max(err[name], compare(name, args, *params))

    def timed(name, args, *params):
        check(name, args, *params)
        ms[name] = cuda_ms(lambda: getattr(tk, f"sketch_{name}")(
            *args, *params))
        plain_ms[name] = cuda_ms(lambda: getattr(tk, f"sketch_{name}_torch")(
            *args, *params))
        log(f"{name} {params} R=8 SB={sb}: equal to twin; kernel "
            f"{ms[name]:.4f} ms, twin {plain_ms[name]:.4f} ms (median of 10,"
            f" {card})")

    args = rows3_inputs(1, sb)
    timed("rows3", args, 31, 25, tk.block_cap(25))
    timed("rows3w", args, 35, 25, tk.block_cap(25))
    timed("rows2", args, 31, 25)
    args = rows3_inputs(2, sb)
    check("rows3", args, 21, 11, tk.block_cap(11))
    check("rows3", args, 21, 11, 256)
    check("rows3w", args, 63, 11, tk.block_cap(11))
    cnt = tk.sketch_rows3(*args, 21, 11, 256)[2]
    if not bool((cnt > 256).any()):
        return fail("the cnt > C case did not overflow C")
    log(f"rows3 k=21 w=11 (C={tk.block_cap(11)} and C=256, max cnt "
        f"{int(cnt.max())}) and rows3w k=63 w=11: equal to twin")

    # --- phase 3: small instance, cuda against cpu ---
    from phi_tpu_torch.eval import build_instance
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

    # --- phases 4 and 5: the main path at size, k = 31 and wide k = 35 ---
    t0 = time.time()
    big = build_instance(49, 5_000_000, coverage=1.0)
    log(f"instance 49 x 5 Mbp, 1x: ready in {time.time() - t0:.1f} s")
    truth = read_truth(big)
    launches = {}
    for phase, k, kern in ((4, 31, "rows3"), (5, 35, "rows3w")):
        flags = ["-k", str(k), "-w", "25", "-R", "100"]
        for run in ("cold", "warm"):
            out = os.path.join(os.path.dirname(big["gfa"]),
                               f"port_k{k}_{run}.fa")
            r, wall, n, peak = run_counted(big, out, flags, dev)
            certified = report(f"phase {phase} k={k} {run}", r, wall, n,
                               peak, truth, 100.0)
            launches.setdefault(kern, n[kern])
            if n[kern] <= 0:
                return fail(f"the k={k} path launched no {kern} kernel")
            if not on_cuda(r):
                return fail("anchor or solver tensors are not on cuda")
            if phase == 5 and not certified:
                return fail("the wide-k run is not certified")
        for args in instance_batches(r, k, 25, dev, False):
            check(kern, args, k, 25, tk.block_cap(25))
        log(f"{kern} equal to twin on the 49 x 5 Mbp instance's first 2 "
            f"batches (k={k})")

    # --- phase 6: the v2 mixed route at chromosome length ---
    from phi_tpu_torch.ops.search import CUCKOO_MAX_KEYS
    t0 = time.time()
    chrom = build_instance(4, 200_000_000, coverage=1.0)
    log(f"instance 4 x 200 Mbp, 1x: ready in {time.time() - t0:.1f} s")
    out = os.path.join(os.path.dirname(chrom["gfa"]), "port.fa")
    r, wall, n, peak = run_counted(chrom, out,
                                   ["-k", "31", "-w", "25", "-R", "100"], dev)
    certified = report("phase 6 v2 mixed", r, wall, n, peak,
                       read_truth(chrom), 100.0)
    launches["rows2"] = n["rows2"]
    if r.anchors.spectrum_size <= CUCKOO_MAX_KEYS:
        return fail(f"spectrum {r.anchors.spectrum_size} keys fits the "
                    f"cuckoo table: the instance does not reach v2 mixed")
    if n["rows2"] <= 0 or n["rows3"] != 0:
        return fail(f"v2 mixed launches: {json.dumps(n)}")
    if not on_cuda(r):
        return fail("anchor or solver tensors are not on cuda")
    if not certified:
        return fail("the v2 mixed run is not certified")
    for args in instance_batches(r, 31, 25, dev, True):
        check("rows2", args, 31, 25)
    log("rows2 equal to twin on the 4 x 200 Mbp instance's first 2 batches")

    replaces = {"rows3": 1000, "rows3w": 1340, "rows2": 688}
    print(json.dumps({"kernels": [{
        "name": n, "route": "cuda", "source": "phi_tpu_torch/csrc/rows.cu",
        "replaces": f"phi_tpu/sketch/kernels.py:{replaces[n]}",
        "launches": launches[n], "max_abs_err": err[n],
        "ms": ms[n], "plain_ms": plain_ms[n]} for n in KERNELS]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
