#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (phi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase15 LENGTH   # phase 15 alone at 49 x LENGTH

Phases, in order; any failure exits non-zero:
  0. the native host library, then the card (nvidia-smi name and power
     limit) and the torch/CUDA versions; no CUDA device -> exit 1;
  1. build the rows kernel family (rows3, rows3w, rows2, rows and seq,
     five instantiations of one tiled kernel) from
     phi_tpu_torch/csrc/rows.cu (into phi_tpu_torch/_build/), and beside
     it, with its nvcc started at the same time, their stage cuts from
     csrc/rows_stages.cu; ptxas's registers, shared memory and spills of
     each of the five, and its resident blocks per SM; a spill fails;
  2. each kernel against its plain torch twin on the card at the production
     shape (R=8, SB=256): rows3 at k=31 w=25 C=2048, plus (k, w) = (21, 11)
     and a cnt > C case; rows3w at k=35 w=25 and k=63 w=11; rows2 and rows
     at k=31 w=25 (rows also at k=21 w=11); seq at k=31 w=25 on one
     5,000,000-base sequence with N runs: outputs array-equal; medians of
     10 CUDA-event timings of one call each (cuda_ms), and each kernel's
     bound (bound_ms below); the median of 10 timings of 5 calls each
     logged beside, and the time split by stage (stage_split); all five
     held against their twins on edge rows (ties, nvalid at tile edges, 0
     and 1 valid lanes, w = 1, a power of two, and 33 and 34,
     k + w - 2 = 128, cnt > C; for seq N at lane 0, at tile and block
     edges, in the last window, a run longer than w + k, and everywhere);
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
     against its twin on the instance's first two packed batches;
  7. the checkpoint on the 49 x 5 Mbp instance at -k 31 -w 25: (a) a
     --save-index run, through the v1 join (rows launches, rows3 does not),
     whose FASTA equals phase 4's warm FASTA; (b) a --load-index run with
     the same flags, the same FASTA and no rows* launch; (c) a --load-index
     re-solve at -R 50 against a default run at -R 50, the same FASTA;
     every run certified; rows against its twin on the first two v1
     batches;
  8. the single-sequence kernel at size: seq against its twin on
     haplotype 0 of that instance with N runs written in (one across a
     block boundary); join_sequence on the N-free haplotype 0 against
     join_many, the same (n_min, positions, ids);
  9. the host hit path on the 49 x 5 Mbp instance: (a) a copy of its graph
     with an N run written into the node of walk 0 that the fewest walks
     visit, at -k 31 -w 25 -R 100: the device anchors hand over, join_many
     (rows) and the native host join of the N walks run, no rows3 launch,
     and every walk without N has the phase 7a index's minimizer count,
     hit positions and ids; (b) -k 35 -w 25 -R 100 --save-index: the
     native join of every walk (sketch_join_walks), no kernel launch, and
     phase 5's warm FASTA; (c) -k 31 -w 100 -R 100 (k + w - 2 beyond the
     kernels' halo): the native join of every walk, no kernel launch, a
     FASTA;
 10. a zero-length chain on the 49 x 5 Mbp instance: 80 empty segments
     inserted after a variant allele node that a retained occurrence
     crosses, in every walk that visits it (the walk sequences, reads and
     truth unchanged), at -k 31 -w 25 -R 100: the device anchors hand over
     ([W::anchors] ... spans past 63 walk positions), rows runs (the host
     hit path), the bracket solve runs on cuda; a certified run must write
     phase 4's warm FASTA (an uncertified one is reported, not failed);
 11. the phase-4 run through the CLI with -d 1 --race on: exit 0, the
     sharing histogram sums to 1, the model dump's summary line, one seq
     launch per walk, phase 4's warm FASTA; and -d 1 on the phase-3
     instance prints the same debug lines on cuda and on cpu;
 12. VCF ingest at MHC scale: a seeded 5 Mbp reference and VCF (1% sites,
     5% indels, an overlapping pair every 1,000 sites, 24 phased diploid
     samples), converted by `python -m phi_tpu_torch.vcfio.vcf2graph`
     into 49 walks, and 1x reads of a 2-switch mosaic of two sample
     haplotypes through the rows3 route at -k 31 -w 25 -R 100; certified;
 13. the eval runners on the phase-4 instance at -k 31 -w 25 -R 100, each
     run's wall, timings, launches and peak device memory logged: (a)
     progressive_subsets over 3, 7, 13, 25 and 49 walks (every row
     certified and through rows3, the 49 row's FASTA == phase 4's); (b)
     run_matrix over the reads and a 0.1x downsample_fastq titration, 3
     runs a cell, both CSVs (the 1x edit distance == phase 4's); (c)
     leave_one_out of walks 0 and 24 (rows3, and one seq launch per kept
     walk for the best-hap baseline); (d) the greedy and best-hap
     baselines; (e) `python -m phi_tpu_torch.eval.scale --haps 49
     --length 5000000 --coverage 1 --runs 3` and (f) `python -m
     phi_tpu_torch.eval.throughput --mbases 64 --repeats 5` as child
     processes (exit 0; the join ran rows and found hits);
 14. the mesh and the device read sketch on the one card: (a) the read
     spectrum of the phase-4 reads (5 Mbp) and of the phase-6 reads (200
     Mbp) by the seq kernel, on 1 shard under PHI_TPU_DEVICE_READ_SKETCH=1
     and on 4 shards of cuda:0, equal to the native scan, with the seq
     launches, the card's busy time (torch.profiler) and the wall of each
     beside the native scan's wall; (b) the phase-4 instance at -k 31 -w
     25 -R 100 through run_pipeline on make_mesh(4, devices=[cuda:0] * 4),
     (dp, hap, sp) = (1, 2, 2), cold then warm: certified, phase 4's warm
     FASTA and report, rows launches and no rows3, 4 seq launches, the
     ladder's sharded solves counted, and the first solve's M bit-equal
     to solve_dp's on the same tables; (c) meshes of 2, 4 and 8 shards on
     cuda:0 and on the CPU on the phase-3 instance: byte-identical FASTA
     and reports (8 shards is the one mesh with dp = 2), equal to phase
     3's; sharded_full_step at 8 shards on cuda:0 against the CPU; (d)
     `python -m phi_tpu_torch.cli ... --mesh 4` with one visible card
     exits 1 with [E::main] naming it and writes no FASTA, and
     `PHI_TPU_DEVICE_READ_SKETCH=1 python -m phi_tpu_torch.eval.throughput
     --mbases 64 --repeats 5` reports the device sketch's bases/s.
 15. chromosome scale, the JAX package's chromosome46 configuration: (a)
     49 haplotypes x 46 Mbp, 2x reads, seed 0, its build's wall; (b)
     eval.onchip.run on it, cold then warm, at -k 31 -w 25 -R 100: every
     run rows3 only, more than one finalize chunk at the default chunk,
     on cuda, within 0.1% edit distance of the truth; the record, the
     hits, the chunks, the certified flag and gap, the recombinations
     against the 2 true breaks, each run's launches and peak device
     memory, and the card's busy share (a third run under torch.profiler,
     phi_tpu_torch.trace's method); (c) the warm run's first solve again
     with PHI_TPU_STREAM_W=0 and =1: M, ends and sweeps bit-equal (unit
     weights), both times and peaks; (d) the warm run's join again with
     PHI_TPU_FIN_CHUNK=2^24, and phase 4's at the default chunk and at
     2^20: the DeviceOcc columns array-equal across chunk sizes; (e) the
     memory model (eval.hbm_budget) beside the measured peaks of phases
     4, 6 and 15, with their ratio (logged, not a failure).
 16. the ground-truth accuracy chain (eval.groundtruth, floor_diag,
     merge_gt, plots), run after phase 5 while phase 6's instance builds
     (16g after phase 15), at the MHC_4 panel's shape: 5 walks x
     4,920,303 bp (synth_pangenome, seed 0) and two synthetic held-out
     truths APD and COX (3-break mosaics with private SNPs at 5e-4)
     under phi_tpu_torch/_build/gt/, the working directory of the phase:
     (a)
     each truth's best-single-walk floor (panel_floor_cached, computed by
     the child that builds the panel, each walk's edit distance timed;
     read back from its cache); (b) run_grid under subs at 0.1, 0.5, 1,
     2, 5 and 10x (APD) and 1 and 10x (COX), indel and longread at 1 and
     10x (APD), 1 seed: every run on cuda with rows3 launches, each
     cell's edit, floor, recombinations, gap, escalation, wall and peak
     device memory logged, uncertified cells reported, and at >= 2x the
     mosaic must beat the floor; (c) a forced escalation (escalate_tol
     -1): escalated, two runs, every PHI_TPU_* variable as before; (d)
     floor_diag.diagnose of APD at 10x: the R = 1 oracle's wall and DP
     solves; (e) the APD 1x subs cell on the CPU: edit, recombinations,
     gap and reads equal to the card's; (f) each grid written as a shard
     and merged per error model: the cells, certified and floor counts
     add up, the six other samples' shards reported missing; (g) phase
     13b's matrix CSV through read_matrix_csv (its reads, coverages and
     the 1x edit); no figure is drawn.
 17. the join pipelines and the packed batches the held graph keeps,
     with the join's spans (the sketch_haps_* keys of timings) logged:
     (a) after 15d, the warm chromosome run's join_anchors_device alone
     with PHI_TPU_PACK_WORKERS=1 and with the default 3: per_hap_min and
     every DeviceOcc column array-equal to the warm run's, each wall, and
     the card's busy share of each (a second call under torch.profiler),
     and the time of the walks' codes the pipeline reads first; (b)
     after phase 4's warm run, a third run from the graph's batches: one
     hit, the warm run's rows3 launches and FASTA byte for byte, its
     sketch_haps and solve_tables beside the warm run's, and a run with
     no batches kept (the memo's limit at 0) beside them; (c) in 16b,
     every pipeline run on the one panel after the first hits the
     batches; (d) after phase 3, its graph on another node chop (every
     segment cut in two), a second graph, packs its own batches; the
     same per-walk minimizer counts, and the DeviceOcc of a run after its
     graph is released.
 18. the mesh's measured collectives (eval.mesh_trace.run) on 4 shards of
     cuda:0: (a) after phase 14, the phase-4 instance (49 x 5 Mbp, 1x, -k
     31 -w 25 -R 100) end to end, the pipeline on one device (rows3) and
     on the mesh (rows, seq), the two FASTAs byte-identical; (b) after
     phase 15, its 49 x 46 Mbp instance, the solve only. Each: the sharded
     exact solve warm, then counted by parallel.sharded.count_collectives,
     bit-equal to the uncounted run and to solve_dp's on the same tables
     (M, end_min, sweeps); every executed sweep and every vote counted
     alike, and one sweep with its vote equal to the closed form
     (eval.mesh_trace.sweep_closed_form); one line of the record's walls,
     sweeps, per-kind calls and bytes, host syncs and launches.
Phases 4-18 set every kernel's launch count to 0 just before each run and
read them just after; the kernels JSON adds the launches of phase 13, of
phase 14's mesh run (14b), of phases 15's and 16's runs and of phase 18 to
those of the phase that first runs each kernel. The second-to-last line is the
kernels JSON, the last the device JSON. Instances are generated from a
seed into phi_tpu_torch/_build/scale/; the two largest and phase 16's
panel by child processes, phase 6's and phase 16's started with the
script and phase 15's once phase 6's is done, which the script waits for
where it needs them and ends if it stops early.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(ROOT, "phi_tpu_torch", "_build")
# the card's name and power limit, as nvidia-smi gives them (set by main),
# printed beside every time and memory number
CARD = ""


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def fail(msg: str) -> int:
    print(f"[smoke] FAILED: {msg}", flush=True)
    return 1


def median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def cuda_times(fn, reps: int = 10, inner: int = 1) -> list[float]:
    """`reps` CUDA-event timings of fn() in ms, after one warm-up. Each is
    `inner` calls between two events, over `inner`: 1 (every kernel time
    of the kernels line and of PERF.md) counts the wrapper's host time of
    the call; 5 hides it behind the card's queue."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return times


def cuda_ms(fn) -> float:
    """Median of 10 CUDA-event timings of one call of fn()."""
    return median(cuda_times(fn))


def rows_inputs(seed: int, sb: int, rows: int = 8):
    """Random A/C/G/T rows with a random 1-30 bp node chop, on the card:
    full, partial, short and empty rows, with and without a left base.
    Returns (codes, nd, nvalid, left, node_off)."""
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
    base = torch.from_numpy(rng.integers(0, 1000, rows).astype(np.int32))
    return (torch.from_numpy(codes).to(dev), nd,
            torch.from_numpy(nvalid).to(dev),
            torch.from_numpy(left.astype(np.int32)).to(dev),
            tk.block_node_offsets(nd, base.to(dev), sb))


def edge_inputs(seed: int, sb: int = 4):
    """16 rows at the tiled design's edges, on the card: nvalid 0, 1, at
    every 1024-lane tile edge of a block, 8191, 8193, one block and a tile
    edge plus one, full; a poly-A row and a period-2 row (every key ties);
    left bases present and absent; node starts of 1-3 with a few saturated
    at 255. Returns (codes, nd, nvalid, left, node_off)."""
    import numpy as np
    import torch
    from phi_tpu_torch.sketch import kernels as tk
    rng = np.random.default_rng(seed)
    L = (sb + 1) * tk.BLK
    full = sb * tk.BLK
    nvalid = [0, 1, 1024, 2048, 3072, 4096, 5120, 6144, 7168, 8191, 8192,
              8193, tk.BLK + 1025, full - 1, full, full - 77]
    codes = rng.integers(0, 4, (16, L), dtype=np.uint8)
    codes[14] = 0
    codes[15] = np.resize(np.array([0, 1], np.uint8), L)
    left = np.where(np.arange(16) % 3 == 0, -1, rng.integers(0, 4, 16))
    nd = (rng.random((16, L)) < 0.1) * rng.integers(1, 4, (16, L))
    nd[rng.random((16, L)) < 0.001] = 255
    nd[:, 0] = 0
    dev = torch.device("cuda")
    nd = torch.from_numpy(nd.astype(np.uint8)).to(dev)
    base = torch.from_numpy(rng.integers(0, 99, 16).astype(np.int32))
    return (torch.from_numpy(codes).to(dev), nd,
            torch.tensor(nvalid, dtype=torch.int32, device=dev),
            torch.from_numpy(left.astype(np.int32)).to(dev),
            tk.block_node_offsets(nd, base.to(dev), sb))


# The kernel instantiations of rows.cu by their entry point's name.
KERNELS = ("rows3", "rows3w", "rows2", "rows", "seq")


def kernel_name(mangled: str) -> str:
    """The entry point's name of a mangled kernel, from its template
    arguments (tiled_kernel<K, COMPACT, POS, NCODE>); another symbol keeps
    its mangled name."""
    import re
    args = re.search(r"tiled_kernelI(.*)EEv", mangled)
    if not args:
        return mangled
    compact, pos, ncode = (f == "1" for f in re.findall(r"Lb([01])E",
                                                        args.group(1)))
    return ("rows3w" if "Key128" in args.group(1) else "rows3" if compact
            else "seq" if ncode else "rows" if pos else "rows2")


def ptxas_report(log: str) -> dict:
    """ptxas's lines per kernel from nvcc -Xptxas -v output: {name: (used
    line, spill line)}, named by kernel_name."""
    import re
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = kernel_name(m.group(1))
            out[name] = ["", ""]
        elif name and "spill" in ln:
            out[name][1] = ln.strip()
        elif name and "Used" in ln:
            out[name][0] = ln.split(":", 1)[-1].strip()
    return out


def spills(line: str) -> bool:
    import re
    return any(int(n) for n in re.findall(r"(\d+) bytes spill", line))


STAGE_CUTS = {1: "pack", 2: "keys and node prefix", 3: "window minimum"}


def start_stage_build():
    """Start nvcc on csrc/rows_stages.cu (the five kernels cut after each
    stage) into a library of its own; returns (path, process)."""
    from phi_tpu_torch.sketch import kernels as tk
    os.makedirs(BUILD, exist_ok=True)
    so = os.path.join(BUILD, "librows-stages.so")
    src = os.path.join(ROOT, "phi_tpu_torch", "csrc", "rows_stages.cu")
    cmd = [tk._nvcc()] + tk._NVCC_FLAGS + ["-o", so, src]
    return so, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)


def stage_library(build):
    """The stage-cut library once its build has ended; raises if nvcc
    failed."""
    import ctypes
    so, proc = build
    err = proc.communicate()[1]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc (rows_stages.cu) failed:\n{err}")
    lib = ctypes.CDLL(so)
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    inputs = [vp, vp, vp, vp, vp, cl, ci, ci, ci, ci]
    pos_inputs = [vp, vp, vp, cl, ci, ci, ci, ci]
    for name, args in (("rows3", inputs + [ci, ci, vp, vp, vp, vp]),
                       ("rows3w", inputs + [ci, ci, vp, vp, vp, vp, vp]),
                       ("rows2", inputs + [ci, vp, vp, vp, vp]),
                       ("rows", pos_inputs + [ci, vp, vp, vp, vp]),
                       ("seq", pos_inputs + [ci, vp, vp, vp, vp])):
        fn = getattr(lib, f"phi_{name}_cut_launch")
        fn.argtypes = args
        fn.restype = ci
    return lib


def stage_split(lib, name: str, args, *params) -> dict:
    """The kernel `name` and its three stage cuts, each launched on the
    outputs of one wrapper call, timed in turns (full, 1, 2, 3, 3, 2, 1,
    full; 10 samples of 5 calls back to back each, so the stages' device
    time is not blurred by the host's). Returns the medians of 20 in ms and
    each stage's time (a cut's median minus the cut's before it)."""
    from phi_tpu_torch.sketch import kernels as tk
    SB = args[0].shape[1] // tk.BLK - 1
    k, w, ints = params[0], params[1], params[2:]
    outs = getattr(tk, f"sketch_{name}")(*args, *params)
    ins = (*args, None) if name == "seq" else args  # seq has no left bases
    runs = {"full": lambda: tk._launch(name, ins, SB, k, w, ints, outs)}
    for cut in STAGE_CUTS:
        runs[cut] = (lambda c: lambda: tk._launch(
            f"{name}_cut", ins, SB, k, w, ints + (c,), outs, lib))(cut)
    order = ["full", *STAGE_CUTS]
    times = {key: [] for key in order}
    for key in order + order[::-1]:
        times[key] += cuda_times(runs[key], inner=5)
    med = {str(key): median(t) for key, t in times.items()}
    cuts = [0.0] + [med[str(c)] for c in STAGE_CUTS] + [med["full"]]
    stages = list(STAGE_CUTS.values()) + ["emit and output"]
    if name in ("rows", "seq"):  # no node plane
        stages[1] = "keys"
    return {"ms": med, "stage_ms": {s: cuts[i + 1] - cuts[i]
                                    for i, s in enumerate(stages)}}


def compare(name: str, args, *params) -> int:
    """Kernel `name` against its twin on the same card tensors; returns the
    max abs error over all outputs and raises if they differ."""
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


def run_port(paths, out, argv, device, mesh=None):
    """One run through the CLI's options (on `mesh` if given); -r is passed
    on --load-index runs too (the reads are not read then), so the FASTA
    record name is the same as the other runs'."""
    from phi_tpu_torch import cli
    from phi_tpu_torch.pipeline import run_pipeline
    opt = cli.options_from_args(cli.build_parser().parse_args(
        ["-g", paths["gfa"], "-r", paths["reads"], "-o", out] + argv))
    return run_pipeline(paths["gfa"], paths["reads"], out, opt, device=device,
                        mesh=mesh)


HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# INT32 issue rate: 132 SMs x 64 INT32 lanes per SM (Hopper architecture
# white paper) x 1.98 GHz boost (the clock behind the data sheet's 67
# TFLOP/s float32)
INT32_OPS_S = 132 * 64 * 1.98e9


def int_ops_per_window(name: str, w: int) -> int:
    """INT32 operations the minimizer algorithm needs for one valid window,
    counting a 64-bit operation as two: the rolling canonical key (forward
    and reverse-complement shift-or, the masks and the min: 9 64-bit ops),
    the window minimum by log-doubling (floor(log2 w) + 1 steps of a key
    compare, a key select and a position select: 5), the dedup test (4);
    the 126-bit key of rows3w doubles the key and compare work; the
    interval variants add the node prefix and the packed interval (4)."""
    steps = w.bit_length()
    wide = name == "rows3w"
    ops = (36 if wide else 18) + steps * (9 if wide else 5) + 4
    return ops + (4 if name in ("rows3", "rows3w", "rows2") else 0)


def bound_ms(name: str, ins, outs, w: int) -> tuple[float, str]:
    """The least time the card could take for one call: the larger of the
    bytes it must move (each input read once, each output written once)
    over the memory rate and the INT32 operations of the valid windows
    (nvalid, the second input of the position variants and the third of
    the interval variants) over the INT32 rate."""
    import torch
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*ins, *outs) if isinstance(t, torch.Tensor))
    nvalid = ins[1] if name in ("rows", "seq") else ins[2]
    ops = int(nvalid.long().sum()) * int_ops_per_window(name, w)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / INT32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def zero_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from phi_tpu_torch.sketch import kernels as tk
    for n in KERNELS:
        getattr(tk, f"sketch_{n}").launches = 0


def read_launches() -> dict:
    """Every kernel wrapper's launch count, by name."""
    from phi_tpu_torch.sketch import kernels as tk
    return {n: getattr(tk, f"sketch_{n}").launches for n in KERNELS}


def run_counted(paths, out, argv, dev, mesh=None):
    """One run of the pipeline on the card (on `mesh` if given) with every
    kernel's launch count set to 0 just before it; returns (result, wall s,
    launches by name, peak device memory B)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.time()
    r = run_port(paths, out, argv, dev, mesh)
    torch.cuda.synchronize()
    wall = time.time() - t0
    return r, wall, read_launches(), torch.cuda.max_memory_allocated()


def report(label: str, r, wall: float, launches, peak: int, truth: str,
           R: float) -> bool:
    """Log one run; returns whether it is certified."""
    from phi_tpu_torch.eval import edit_stats
    from phi_tpu_torch.pipeline import gap_tol
    gap = max(0.0, r.decode.true_objective - r.decode.dp_objective)
    es = edit_stats(r.sequence, truth)
    log(f"{label}: wall {wall:.3f} s ({CARD}); timings "
        + json.dumps({k: round(v, 4) for k, v in r.timings.items()}))
    occ = r.anchors.device_occ
    if occ is not None:
        anchors = (f"{occ.n_hits} join hits, {occ.n_occ} retained "
                   f"occurrences; anchors on {occ.dev_s.device}")
    else:  # the hit path: tables built on the host from the join hits
        anchors = (f"host anchor tables from the join hits, "
                   f"{len(r.anchors.occ_hap)} retained occurrences")
    log(f"{label}: peak device memory {peak} B ({CARD}); launches "
        f"{json.dumps(launches)}; spectrum {r.anchors.spectrum_size} keys; "
        f"{anchors}; solver on "
        f"{r.decode.solver_device}, {r.decode.n_sweeps} DP sweeps; gap "
        f"{gap:.3f} (certified "
        f"{gap <= gap_tol(R)}); recombinations {r.recombination_count}; "
        f"edit distance to truth {es.edit_distance} (identity "
        f"{es.identity:.6f})")
    return gap <= gap_tol(R)


def on_cuda(r) -> bool:
    occ = r.anchors.device_occ
    return ((occ is None or occ.dev_s.device.type == "cuda")
            and r.decode.solver_device.startswith("cuda"))


def same_file(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


SEQ_EDGES = ("lane 0", "tile and block edges", "last window", "long run",
             "all N")


def seq_edge_codes(kind: str, k: int, w: int, seed: int = 0):
    """A 2.6-block A/C/G/T sequence with N (4) where the tiled seq kernel
    has its edges: at lane 0; across the tile edge 1023/1024, the block
    edge 8191/8192 and a tile edge of the next block; in the sequence's
    last window; a run longer than w + k across a tile edge; or N
    everywhere."""
    import numpy as np
    from phi_tpu_torch.sketch import kernels as tk
    rng = np.random.default_rng(seed)
    L = 2 * tk.BLK + 5000
    codes = rng.integers(0, 4, L, dtype=np.uint8)
    if kind == "lane 0":
        codes[0] = 4
    elif kind == "tile and block edges":
        for at in (1023, tk.BLK - 1, tk.BLK + 2047):
            codes[at:at + 2] = 4
    elif kind == "last window":
        codes[L - 3] = 4
    elif kind == "long run":
        codes[3000:3000 + w + k + 5] = 4
    else:
        codes[:] = 4
    return codes


def seq_with_n(codes, rng):
    """A copy of codes with N runs written in: one across the first block
    boundary, twelve more at random places."""
    import numpy as np
    from phi_tpu_torch.sketch import kernels as tk
    out = np.array(codes, np.uint8)
    out[tk.BLK - 20:tk.BLK + 15] = 4
    for at in rng.integers(0, len(out) - 100, 12):
        out[at:at + rng.integers(1, 60)] = 4
    return out


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


def join_batches(r, k: int, w: int, dev):
    """The rows kernel's inputs (codes, nvalid, left) of the first two v1
    batches of a run's graph, packed as join_many packs them."""
    from phi_tpu_torch.sketch import kernels as tk
    g = r.graph
    seqs = [g.walk_seq_codes(h) for h in range(g.num_walks)]
    row_lanes = (tk.SUPER_BLOCKS + 1) * tk.BLK
    _, rows = tk.plan_join_rows(seqs, k, w)
    for b in range(2):
        batch = rows[b * tk.ROWS:(b + 1) * tk.ROWS]
        words, nv, left = tk.pack_join_batch(seqs, batch, row_lanes, dev)
        yield tk.unpack_2bit(words, row_lanes), nv, left


def n_walk_copy(graph, src: str, dst: str):
    """Copy the graph file src to dst with an N run written over the middle
    half of the node of walk 0 that the fewest walks visit (the longest
    such node). Returns (the node's name, the walks that visit it)."""
    import numpy as np
    wm, wl = graph.walk_mat, graph.walk_len
    visits = np.bincount(wm[wm >= 0], minlength=graph.n_vtx)
    walk0 = wm[0, :wl[0]]
    lens = graph.gfa.node_len[walk0]
    v = int(walk0[np.lexsort((-lens, visits[walk0]))[0]])
    name = graph.gfa.seg_names[v]
    holders = [h for h in range(graph.num_walks)
               if (wm[h, :wl[h]] == v).any()]
    with open(src) as fi, open(dst, "w") as fo:
        for ln in fi:
            if ln.startswith(f"S\t{name}\t"):
                parts = ln.rstrip("\n").split("\t")
                seq = parts[2]
                q = len(seq) // 4
                parts[2] = seq[:q] + "N" * (len(seq) - 2 * q) + \
                    seq[len(seq) - q:]
                ln = "\t".join(parts) + "\n"
            fo.write(ln)
    return name, holders


def read_truth(paths) -> str:
    with open(paths["truth"]) as f:
        return "".join(ln.strip() for ln in f if not ln.startswith(">"))


@contextlib.contextmanager
def stderr_tee():
    """Everything written to sys.stderr inside the block still goes there,
    and also into the StringIO it yields (the [W::] and [D] lines)."""
    buf, real = io.StringIO(), sys.stderr

    class Tee:
        def write(self, s):
            buf.write(s)
            return real.write(s)

        def __getattr__(self, name):
            return getattr(real, name)

    sys.stderr = Tee()
    try:
        yield buf
    finally:
        sys.stderr = real


def chain_site(r):
    """(h, i): walk position i of walk h, whose node v some but not all
    walks visit, every walk that visits v leaves to the same node, and a
    retained occurrence of run r crosses from v into that node (the first
    such occurrence of r's anchors)."""
    import numpy as np
    g, a = r.graph, r.anchors
    a.materialize_device()
    wm, wl = g.walk_mat, g.walk_len
    cols = np.arange(wm.shape[1])[None, :]
    inner = cols < (wl - 1)[:, None]          # lane states with a successor
    u = wm[:, :-1][inner[:, :-1]].astype(np.int64)
    s = wm[:, 1:][inner[:, :-1]].astype(np.int64)
    pairs = np.unique(u * g.n_vtx + s)
    n_succ = np.bincount(pairs // g.n_vtx, minlength=g.n_vtx)
    visits = np.bincount(wm[wm >= 0], minlength=g.n_vtx)
    ends = np.zeros(g.n_vtx, bool)
    ends[wm[np.arange(g.num_walks), wl - 1]] = True
    cand = (n_succ == 1) & (visits < g.num_walks) & ~ends
    is_cand = np.where(wm >= 0, cand[np.maximum(wm, 0)], False) & inner
    csum = np.concatenate([np.zeros((len(wm), 1), np.int64),
                           np.cumsum(is_cand, axis=1)], axis=1)
    # an occurrence covers walk positions [start, end): it crosses the
    # edges out of start .. end - 2
    h, st, en = a.occ_hap, a.occ_start, a.occ_end
    hit = np.flatnonzero(csum[h, en - 1] - csum[h, st] > 0)
    if not len(hit):
        raise RuntimeError("no retained occurrence crosses a variant allele "
                           "node with one successor")
    o = hit[0]
    i = int(st[o]) + int(np.argmax(is_cand[h[o], st[o]:en[o] - 1]))
    return int(h[o]), i


@contextlib.contextmanager
def spy(module, name: str):
    """Wrap module.name for the block: every call still runs, and its
    (positional args, return value) is appended to the list the block
    gets."""
    real, seen = getattr(module, name), []

    def wrapped(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append((args, out))
        return out

    setattr(module, name, wrapped)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def debug_lines(err: str) -> list[str]:
    """The -d lines of a run's stderr: the sharing histogram and [D]."""
    return [ln for ln in err.splitlines()
            if ln.startswith(("[D]", "[Haplotypes:", "Shared fraction"))]


def cli_counted(argv):
    """One run of the CLI's main (the card unless argv says --device cpu)
    with every kernel's launch count set to 0 just before it and its stderr
    kept; returns (exit code, the run's PipelineResult or None, wall s,
    launches by name, peak device memory B, stderr)."""
    import torch
    from phi_tpu_torch import cli, pipeline
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.time()
    with stderr_tee() as err, spy(pipeline, "run_pipeline") as runs:
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    return (rc, runs[0][1] if runs else None, wall, read_launches(),
            torch.cuda.max_memory_allocated(), err.getvalue())


@contextlib.contextmanager
def per_run():
    """Wrap pipeline.run_pipeline for the block (the eval runners call it
    through the module): every call still runs, and its graph file, wall,
    launches by kernel (the counts after it minus those before it), peak
    device memory (reset just before it; the peak before the reset is kept
    as peak_before) and result are appended to the list the block gets."""
    import torch
    from phi_tpu_torch import pipeline
    real, seen = pipeline.run_pipeline, []

    def wrapped(gfa_path, *args, **kwargs):
        torch.cuda.synchronize()
        peak_before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = read_launches()
        t0 = time.time()
        r = real(gfa_path, *args, **kwargs)
        torch.cuda.synchronize()
        seen.append({"gfa": gfa_path, "wall": time.time() - t0,
                     "launches": {n: c - before[n]
                                  for n, c in read_launches().items()},
                     "peak": torch.cuda.max_memory_allocated(),
                     "peak_before": peak_before, "result": r})
        return r

    pipeline.run_pipeline = wrapped
    try:
        yield seen
    finally:
        pipeline.run_pipeline = real


def log_runs(label: str, runs) -> None:
    """One line per pipeline run of per_run: wall, timings, launches and
    peak device memory, with the card."""
    for i, run in enumerate(runs):
        r = run["result"]
        log(f"{label} run {i} ({os.path.basename(run['gfa'])}, "
            f"{r.graph.num_walks} walks): wall {run['wall']:.3f} s; peak "
            f"device memory {run['peak']} B; launches "
            f"{json.dumps(run['launches'])} ({CARD}); timings "
            + json.dumps({k: round(v, 4) for k, v in r.timings.items()}))


# Runs a module as `python -m` does (sys.argv[1] is the module, the rest its
# arguments), with every kernel's launch count at 0, and writes its launches
# and peak device memory to stderr as one "[probe] {json}" line at exit.
PROBE = """
import json, runpy, sys, torch
from phi_tpu_torch.sketch import kernels as tk
names = %r
for n in names:
    getattr(tk, "sketch_" + n).launches = 0
sys.argv = sys.argv[1:]
rc = 0
try:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
except SystemExit as e:
    rc = e.code or 0
torch.cuda.synchronize()
sys.stderr.write("[probe] " + json.dumps({
    "launches": {n: getattr(tk, "sketch_" + n).launches for n in names},
    "peak": torch.cuda.max_memory_allocated()}) + "\\n")
sys.exit(rc)
""" % (KERNELS,)


def module_counted(module: str, args: list[str], timeout: int, env=None):
    """`python -m module args` as a child process through PROBE (with the
    environment `env`, by default this process's); returns (exit code,
    wall s, stdout, its launches by kernel, its peak device memory B,
    stderr). The launches and peak are None if the child did not reach
    its end."""
    t0 = time.time()
    res = subprocess.run([sys.executable, "-c", PROBE, module, *args],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=timeout, env=env)
    wall = time.time() - t0
    probe = [ln for ln in res.stderr.splitlines() if ln.startswith("[probe] ")]
    got = json.loads(probe[-1][len("[probe] "):]) if probe else {}
    return (res.returncode, wall, res.stdout, got.get("launches"),
            got.get("peak"), res.stderr)


def chain_copy(r, dst: str, n: int = 80):
    """Write the graph of run r to dst with a chain of n empty segments
    z0..z{n-1} after the node v of chain_site(r), in every walk that visits
    v (links v -> z0 -> ... -> z{n-1} -> the node after v, in place of
    v -> that node). The walk sequences do not change, so r's reads and
    truth still apply, and a k-mer of r's model now spans the chain.
    Returns (v's name, the walks that visit it)."""
    import dataclasses
    import numpy as np
    from phi_tpu_torch.io.gfa import write_gfa
    h, i = chain_site(r)
    gd = r.graph.gfa
    v, nxt = int(gd.walks[h][i]), int(gd.walks[h][i + 1])
    z = np.arange(gd.n_vtx, gd.n_vtx + n, dtype=np.int32)
    walks, holders = [], []
    for j, wk in enumerate(gd.walks):
        at = np.flatnonzero(wk == v)
        if len(at):
            holders.append(j)
            wk = np.insert(wk, int(at[0]) + 1, z)
        walks.append(wk)
    keep = ~((gd.edge_u == v) & (gd.edge_v == nxt))
    chain_u = np.concatenate([[v], z])
    chain_v = np.concatenate([z, [nxt]])
    out = dataclasses.replace(
        gd, seg_names=gd.seg_names + [f"z{j}" for j in range(n)],
        node_len=np.concatenate([gd.node_len, np.zeros(n, np.int64)]),
        node_off=np.concatenate([gd.node_off,
                                 np.full(n, gd.node_off[-1], np.int64)]),
        edge_u=np.concatenate([gd.edge_u[keep], chain_u]).astype(np.int32),
        edge_v=np.concatenate([gd.edge_v[keep], chain_v]).astype(np.int32),
        walks=walks,
        seg_tags=gd.seg_tags + [""] * n if gd.seg_tags else gd.seg_tags)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    write_gfa(out, path=dst)
    return gd.seg_names[v], holders


def write_vcf(ref_path: str, vcf_path: str, length: int, n_samples: int,
              seed: int = 0, var_rate: float = 0.01,
              indel_fraction: float = 0.05, overlap_every: int = 1000):
    """A random reference of `length` bases (contig chr6, FASTA) and a VCF
    of biallelic sites at var_rate: indel_fraction of them indels (half
    insertions, half deletions of 1-5 bases), the rest SNPs; every
    overlap_every-th site an overlapping pair instead (a 4-base deletion
    and a SNP inside it); n_samples phased diploid samples S0..S{n-1}, each
    site at its own allele frequency in 0.1-0.9. Returns (ref, records),
    records sorted by position as (pos, REF, ALT, alt mask bool
    [2 * n_samples]) with haplotype 2 s + j the walk S{s}.{j}."""
    import numpy as np
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def rand_seq(m):
        return acgt[rng.integers(0, 4, m)].tobytes().decode()

    ref = rand_seq(length)
    n_sites = int(length * var_rate)
    pos = np.sort(rng.choice(np.arange(1, length - 10), n_sites,
                             replace=False))
    sites = []
    for j, p in enumerate(pos.tolist()):
        kind = rng.random()
        if j % overlap_every == overlap_every // 2:
            sites.append((p, ref[p:p + 5], ref[p]))
            p, kind = p + 2, 1.0
        if kind < indel_fraction / 2:
            sites.append((p, ref[p], ref[p] + rand_seq(int(rng.integers(1, 6)))))
        elif kind < indel_fraction:
            sites.append((p, ref[p:p + 1 + int(rng.integers(1, 6))], ref[p]))
        else:
            sites.append((p, ref[p], "ACGT"[("ACGT".index(ref[p])
                                             + int(rng.integers(1, 4))) % 4]))
    freq = rng.uniform(0.1, 0.9, len(sites))
    alt = rng.random((len(sites), 2 * n_samples)) < freq[:, None]
    order = sorted(range(len(sites)), key=lambda j: sites[j][0])
    records = [(*sites[j], alt[j]) for j in order]
    with open(ref_path, "w") as f:
        f.write(">chr6\n")
        f.writelines(ref[j:j + 80] + "\n" for j in range(0, length, 80))
    gt = np.array(["0", "1"])
    with open(vcf_path, "w") as f:
        f.write("##fileformat=VCFv4.2\n"
                f"##contig=<ID=chr6,length={length}>\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(f"S{s}" for s in range(n_samples)) + "\n")
        for p, ra, aa, m in records:
            g = gt[m.astype(np.int64)]
            f.write(f"chr6\t{p + 1}\t.\t{ra}\t{aa}\t.\tPASS\t.\tGT\t"
                    + "\t".join(np.char.add(np.char.add(g[0::2], "|"),
                                            g[1::2])) + "\n")
    return ref, records


def realize(ref: str, records, hap: int) -> str:
    """Haplotype `hap`'s sequence under write_vcf's records, as the
    converter realizes it: alleles in position order, an alt allele that
    overlaps one already applied dropped."""
    parts, cur = [], 0
    for p, ra, aa, m in records:
        if not m[hap] or p < cur:
            continue
        parts += [ref[cur:p], aa]
        cur = p + len(ra)
    parts.append(ref[cur:])
    return "".join(parts)


def phase13(big, dev, main_fa: str, main_edit: int, g49, launches) -> int:
    """Phase 13: the eval runners on the phase-4 instance (paths `big`, its
    graph g49, phase 4's warm FASTA and edit distance), on `dev`; adds their
    launches to `launches`. Returns 0, or 1 after a failure line."""
    import torch
    from phi_tpu_torch.config import Options
    from phi_tpu_torch.eval import baselines, batch, crossval, scale
    from phi_tpu_torch.pipeline import gap_tol
    t13 = time.time()
    opt = Options(k=31, w=25, recombination=100.0)
    bdir = os.path.dirname(big["gfa"])

    def runner(label, fn):
        """fn() with every launch count at 0 just before it and its
        pipeline runs logged; returns (fn's result, its runs, launches)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.time()
        with per_run() as runs:
            out = fn()
        torch.cuda.synchronize()
        wall, n = time.time() - t0, read_launches()
        for kern in KERNELS:
            launches[kern] += n[kern]
        peak = max([torch.cuda.max_memory_allocated()]
                   + [max(r["peak"], r["peak_before"]) for r in runs])
        log(f"{label}: wall {wall:.3f} s, {len(runs)} pipeline runs, "
            f"launches {json.dumps(n)}, peak device memory {peak} B "
            f"({CARD})")
        log_runs(label, runs)
        return out, runs, n

    # 13a: the increasing.csv axis, chop_graph.sh style
    counts = [3, 7, 13, 25, 49]
    rows, runs, _ = runner("phase 13a progressive_subsets", lambda: (
        scale.progressive_subsets(
            big["gfa"], big["reads"], big["truth"], counts, opt=opt,
            out_csv=os.path.join(bdir, "increasing.csv"), target_runs=1,
            device=dev)))
    for row in rows:
        log(f"phase 13a row: {json.dumps(row)}")
    with open(os.path.join(bdir, "increasing.csv")) as f:
        log("phase 13a increasing.csv:\n" + f.read().rstrip())
    if [row["n_haps"] for row in rows] != counts or len(runs) != len(counts):
        return fail(f"phase 13a: rows {[row['n_haps'] for row in rows]}, "
                    f"{len(runs)} runs")
    for row, run in zip(rows, runs):
        if row["gap"] > gap_tol(100.0):
            return fail(f"phase 13a: the {row['n_haps']}-haplotype row is "
                        f"not certified (gap {row['gap']})")
        if run["launches"]["rows3"] <= 0 or not on_cuda(run["result"]):
            return fail(f"phase 13a: the {row['n_haps']}-haplotype run "
                        f"launched no rows3 kernel or left the card")
    if not same_file(os.path.join(bdir, "inferred_49.fa"), main_fa):
        return fail("phase 13a: the 49-haplotype row's FASTA differs from "
                    "phase 4 (warm)")
    log("phase 13a: every row certified; the 49-haplotype FASTA == phase 4 "
        "warm FASTA")

    # 13b: the reads x coverage matrix, the reads and a 0.1x titration
    tenth = os.path.join(bdir, "reads_0.1.fq.gz")
    kept = batch.downsample_fastq(big["reads"], tenth, 0.1, seed=11)
    log(f"phase 13b: downsample_fastq 0.1: {kept} reads")
    cells = [("sim", "1x", big["reads"], big["truth"]),
             ("sim", "0.1x", tenth, big["truth"])]
    matrix_csv = os.path.join(bdir, "matrix.csv")
    res, runs, _ = runner("phase 13b run_matrix", lambda: batch.run_matrix(
        big["gfa"], cells, opt, out_csv=matrix_csv, target_runs=3,
        device=dev))
    for path in (matrix_csv, matrix_csv + ".stats.csv"):
        with open(path) as f:
            log(f"phase 13b {os.path.basename(path)}:\n" + f.read().rstrip())
    if any(run["launches"]["rows3"] <= 0 for run in runs):
        return fail("phase 13b: a run launched no rows3 kernel")
    if res[0].edit_distance != main_edit:
        return fail(f"phase 13b: the 1x cell's edit distance "
                    f"{res[0].edit_distance} differs from phase 4's "
                    f"{main_edit}")

    # 13c: leave-one-out on two walks
    targets = [g49.walk_names[0], g49.walk_names[24]]
    rows, runs, n = runner("phase 13c leave_one_out", lambda: (
        crossval.leave_one_out(big["gfa"], 1.0, targets=targets, opt=opt,
                               device=dev)))
    for row in rows:
        log(f"phase 13c row: {json.dumps(row)}; edit <= best_hap_edit: "
            f"{row['edit'] <= row['best_hap_edit']}")
    if len(rows) != 2 or any(run["launches"]["rows3"] <= 0 for run in runs):
        return fail(f"phase 13c: {len(rows)} rows, launches "
                    f"{[run['launches'] for run in runs]}")
    if n["seq"] != 2 * (g49.num_walks - 1):
        return fail(f"phase 13c: {n['seq']} seq launches for 2 folds of "
                    f"{g49.num_walks - 1} kept walks")

    # 13d: the two baselines on the phase-4 files
    files = (big["gfa"], big["reads"], big["truth"])
    for label, fn, kern in (
            ("greedy", baselines.run_greedy_baseline, "rows3"),
            ("best-hap", baselines.run_best_hap_baseline, "seq")):
        rec, _, n = runner(f"phase 13d {label} baseline",
                           lambda fn=fn: fn(*files, device=dev))
        log(f"phase 13d {label} baseline: {json.dumps(rec)}")
        if n[kern] <= 0:
            return fail(f"phase 13d: the {label} baseline launched no "
                        f"{kern} kernel")

    # 13e and 13f: the scale and throughput CLIs as child processes
    for label, module, args in (
            ("13e", "phi_tpu_torch.eval.scale",
             ["--haps", "49", "--length", "5000000", "--coverage", "1",
              "--runs", "3"]),
            ("13f", "phi_tpu_torch.eval.throughput",
             ["--mbases", "64", "--repeats", "5"])):
        rc, wall, out, n, peak, err = module_counted(module, args, 600)
        lines = [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith("{")]
        for line in lines:
            log(f"phase {label} {module}: {json.dumps(line)}")
        log(f"phase {label}: exit {rc}, wall {wall:.3f} s (the child "
            f"process), launches {json.dumps(n)}, peak device memory {peak} "
            f"B ({CARD})")
        if rc != 0 or not lines or n is None:
            return fail(f"phase {label}: {module} exited {rc}: {err[-2000:]}")
        for kern in KERNELS:
            launches[kern] += n[kern]
        if label == "13e" and (lines[0]["gap"] > gap_tol(100.0)
                               or n["rows3"] <= 0):
            return fail("phase 13e: not certified, or no rows3 launch")
        if label == "13f":
            join = [line for line in lines if line["metric"] == "join"]
            if n["rows"] <= 0 or not join or join[0]["hits"] <= 0:
                return fail("phase 13f: the join ran no rows kernel or found "
                            "no hits")
    log(f"phase 13: {time.time() - t13:.3f} s in all ({CARD})")
    return 0


def profiled_busy(fn):
    """fn() once more under torch.profiler: the card's busy seconds in it
    (the union of its kernel, copy and fill intervals)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from phi_tpu_torch.trace import device_events, merged_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return merged_us((s, e) for _, s, e in device_events(prof)) / 1e6


def phase14(big, chrom, small, dev, main_fa: str, main_report, small_fa,
            launches) -> int:
    """Phase 14: the mesh and the device read sketch on the one card (paths
    of the phase-4, phase-6 and phase-3 instances, phase 4's warm FASTA and
    (report, recombinations), phase 3's FASTA); adds the mesh run's (14b)
    launches to `launches`. Returns 0, or 1 after a failure line."""
    import numpy as np
    import torch
    from phi_tpu_torch import pipeline
    from phi_tpu_torch.io.reads import load_read_batch
    from phi_tpu_torch.parallel.sharded import (make_mesh,
                                                prepare_sharded_tables,
                                                sharded_full_step)
    from phi_tpu_torch.sketch.minimizer import (DEVICE_READ_SKETCH,
                                                native_spectrum,
                                                sketch_read_concat)
    from phi_tpu_torch.solve.dp import solve_dp
    from phi_tpu_torch.solve.prep import build_solver_tables
    t14 = time.time()
    flags = ["-k", "31", "-w", "25", "-R", "100"]

    # 14a: the device read sketch at 5 and 200 Mbp, 1 and 4 shards
    for label, paths in (("5 Mbp", big), ("200 Mbp", chrom)):
        t0 = time.time()
        reads = load_read_batch(paths["reads"])
        t_load = time.time() - t0
        t0 = time.time()
        want = native_spectrum(reads.concat, reads.off, 31, 25)
        t_native = time.time() - t0
        log(f"phase 14a {label}: {reads.n_reads} reads, {reads.total_bases} "
            f"bases loaded in {t_load:.3f} s; native scan {t_native:.3f} s, "
            f"spectrum {len(want[0])} keys ({CARD})")
        for shards in (1, 4):
            devices = [dev] * shards if shards > 1 else None
            if shards == 1:
                os.environ[DEVICE_READ_SKETCH] = "1"
            try:
                def sketch():
                    return sketch_read_concat(reads.concat, reads.off, 31, 25,
                                              devices=devices, device=dev)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_launches()
                t0 = time.time()
                got = sketch()
                torch.cuda.synchronize()
                wall, n = time.time() - t0, read_launches()
                peak = torch.cuda.max_memory_allocated()
                busy = profiled_busy(sketch)
            finally:
                os.environ.pop(DEVICE_READ_SKETCH, None)
            same = all(np.array_equal(a, b) for a, b in zip(got, want))
            log(f"phase 14a {label}, {shards} shard(s) on {dev}: wall "
                f"{wall:.3f} s (native {t_native:.3f} s), card busy "
                f"{busy:.4f} s (a second, profiled call), seq launches "
                f"{n['seq']}, peak device memory {peak} B, spectrum equal "
                f"to the native scan: {same} ({CARD})")
            if not same:
                return fail(f"phase 14a {label}, {shards} shard(s): the "
                            f"spectrum differs from the native scan")
            if n["seq"] < shards or n["seq"] != sum(
                    v for v in n.values()):
                return fail(f"phase 14a {label}: launches {json.dumps(n)}")
        del reads

    # 14b: the mesh at size, four shards of cuda:0
    mesh = make_mesh(4, devices=[dev] * 4)
    bdir = os.path.dirname(big["gfa"])
    mesh_fa = os.path.join(bdir, "port_mesh.fa")
    for run in ("cold", "warm"):
        with spy(pipeline, "solve_dp_sharded") as solves:
            r, wall, n, peak = run_counted(big, mesh_fa, flags, dev, mesh)
        certified = report(f"phase 14b mesh {mesh!r} {run}", r, wall, n,
                           peak, read_truth(big), 100.0)
        log(f"phase 14b {run}: {len(solves)} sharded solves (the ladder's "
            f"re-solves: {len(solves) - 1}), solver on "
            f"{r.decode.solver_device} ({CARD})")
        if not certified:
            return fail("phase 14b: the mesh run is not certified")
        if n["rows"] <= 0 or n["rows3"] or n["seq"] != 4:
            return fail(f"phase 14b launches: {json.dumps(n)}")
        if not same_file(mesh_fa, main_fa) or (
                r.report_segments, r.recombination_count) != main_report:
            return fail("phase 14b: FASTA or report differs from phase 4 "
                        "(warm)")
        if not solves or not r.decode.solver_device.startswith(dev.type):
            return fail(f"phase 14b: no sharded solve on {dev.type}")
        (tables, _, max_sweeps), (sol, ends, sweeps, _) = solves[0]
        one, ends1, sweeps1, _ = solve_dp(tables, max_sweeps, dev)
        equal = (torch.equal(sol.M, one.M) and np.array_equal(ends, ends1)
                 and sweeps == sweeps1)
        log(f"phase 14b {run}: the first solve's M [{tuple(sol.M.shape)}], "
            f"ends and {sweeps} sweeps bit-equal to solve_dp's on {dev}: "
            f"{equal}")
        if not equal:
            return fail("phase 14b: the sharded M differs from solve_dp's")
        del solves, sol, one, tables
    for kern in ("rows", "seq"):
        launches[kern] += n[kern]

    # 14c: small meshes on cuda:0 and on the CPU, the phase-3 instance
    sdir = os.path.dirname(small["gfa"])
    first = None
    for n_shards in (2, 4, 8):
        for d in (dev, torch.device("cpu")):
            out = os.path.join(sdir, f"port_mesh{n_shards}_{d.type}.fa")
            m = make_mesh(n_shards, devices=[d] * n_shards)
            t0 = time.time()
            r = run_port(small, out, [], d, m)
            log(f"phase 14c {m!r}: wall {time.time() - t0:.3f} s, "
                f"{r.recombination_count} recombinations, bound "
                f"{r.decode.dp_objective:.3f}, objective "
                f"{r.decode.true_objective:.3f} ({CARD})")
            key = (r.report_segments, r.recombination_count,
                   r.decode.dp_objective, r.decode.true_objective)
            if first is None:
                first = key
            if key != first or not same_file(out, small_fa):
                return fail(f"phase 14c: {m!r} differs (FASTA against "
                            f"phase 3's, report, bound or objective)")
    log("phase 14c: meshes of 2, 4 and 8 shards on cuda:0 and the CPU: "
        "byte-identical FASTA (== phase 3's), same report, bound and "
        "objective")
    reads = load_read_batch(small["reads"])
    n_reads = 256
    lens = np.diff(reads.off)[:n_reads].astype(np.int32)
    codes = np.full((n_reads, int(lens.max())), 4, np.uint8)
    for i in range(n_reads):
        codes[i, :lens[i]] = reads.concat[reads.off[i]:reads.off[i + 1]]
    spectrum = native_spectrum(reads.concat[:reads.off[n_reads]],
                               reads.off[:n_reads + 1], 31, 25)
    tables = build_solver_tables(r.graph, r.anchors, 100.0)
    outs = []
    for d in (dev, torch.device("cpu")):
        m = make_mesh(8, devices=[d] * 8)
        S, B, sv, wl = prepare_sharded_tables(tables, m)
        zero_launches()
        t0 = time.time()
        hits, M, end_min = sharded_full_step(
            m, k=31, w=25, R=100.0, n_vtx=tables.n_vtx, n_sweeps=4)(
            codes, lens, *spectrum, S, B, sv, wl, tables.esrc_h,
            tables.esrc_p, tables.esrc_target)
        outs.append((hits.cpu(), M.cpu(), end_min))
        log(f"phase 14c sharded_full_step {m!r}: {time.time() - t0:.3f} s, "
            f"seq launches {read_launches()['seq']}, {int(hits.sum())} hits "
            f"of {len(spectrum[0])} keys, end_min {end_min} ({CARD})")
    (h1, m1, e1), (h2, m2, e2) = outs
    if not (torch.equal(h1, h2) and torch.equal(m1, m2) and e1 == e2):
        return fail("phase 14c: sharded_full_step differs between cuda:0 "
                    "and the CPU")

    # 14d: the CLI's too-few-cards refusal, the device sketch's throughput
    cli_fa = os.path.join(bdir, "port_mesh_cli.fa")
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "phi_tpu_torch.cli", "-g", big["gfa"], "-r",
         big["reads"], "-o", cli_fa, "--mesh", "4"] + flags,
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    log(f"phase 14d: --mesh 4 on {torch.cuda.device_count()} visible card: "
        f"exit {res.returncode} in {time.time() - t0:.3f} s, stderr "
        f"{res.stderr.strip()[-300:]!r}")
    if res.returncode != 1 or "[E::main]" not in res.stderr \
            or "1 visible" not in res.stderr or os.path.exists(cli_fa):
        return fail("phase 14d: --mesh 4 on one card was not refused")
    rc, wall, stdout, n, peak, err = module_counted(
        "phi_tpu_torch.eval.throughput", ["--mbases", "64", "--repeats",
                                          "5"], 600,
        env=dict(os.environ, **{DEVICE_READ_SKETCH: "1"}))
    lines = [json.loads(ln) for ln in stdout.splitlines()
             if ln.startswith("{")]
    for line in lines:
        log(f"phase 14d throughput (device read sketch): {json.dumps(line)}")
    log(f"phase 14d: exit {rc}, wall {wall:.3f} s (the child process), "
        f"launches {json.dumps(n)}, peak device memory {peak} B ({CARD})")
    sketch = [line for line in lines if line["metric"] == "sketch"]
    if rc != 0 or not sketch or n is None or n["seq"] <= 0:
        return fail(f"phase 14d: the throughput runner exited {rc} or ran "
                    f"no seq kernel: {err[-2000:]}")
    log(f"phase 14: {time.time() - t14:.3f} s in all ({CARD})")
    return 0


def phase18(label: str, dev, shape, launches, skip_e2e: bool) -> int:
    """Phase 18 (`label` a or b): eval.mesh_trace.run on the instance
    `shape` (haplotypes, length, coverage; seed 0) over 4 shards of `dev`,
    the launches counted from 0 and added to `launches`. Returns 0, or 1
    after a failure line."""
    from phi_tpu_torch.eval import mesh_trace
    zero_launches()
    t0 = time.time()
    rec = mesh_trace.run(*shape, 0, skip_e2e=skip_e2e, device=dev, shards=4)
    wall, n = time.time() - t0, read_launches()
    comm = rec["collectives"]
    keys = ("n_devices", "mesh", "byte_identical_mesh_vs_single",
            "wall_single_s", "wall_mesh_s", "solve_wall_mesh_s",
            "solve_wall_single_s", "solve_bit_equal_mesh_vs_single",
            "solve_bit_equal_counted_vs_not", "n_sweeps", "n_vtx",
            "n_layers", "block", "per_sweep_mb_per_device",
            "closed_form_per_sweep")
    log(f"phase 18{label} mesh_trace {shape} (haplotypes, length, coverage)"
        f", {wall:.3f} s in all ({rec['device']}): " + json.dumps(
            {**{k: rec[k] for k in keys}, "collectives": comm,
             "launches": {k: n[k] for k in ("rows3", "rows", "seq")}}))
    for kern in ("rows3", "rows", "seq"):
        launches[kern] += n[kern]
    if not skip_e2e and rec["byte_identical_mesh_vs_single"] is not True:
        return fail(f"phase 18{label}: the mesh FASTA differs from the "
                    f"single-device run's")
    if not rec["solve_bit_equal_mesh_vs_single"]:
        return fail(f"phase 18{label}: the sharded M, end_min or sweeps "
                    f"differ from solve_dp's")
    if not rec["solve_bit_equal_counted_vs_not"]:
        return fail(f"phase 18{label}: the counted solve differs from the "
                    f"uncounted one")
    if not comm["uniform"] or comm["per_sweep"] != \
            rec["closed_form_per_sweep"]:
        return fail(f"phase 18{label}: the per-sweep counts differ from "
                    f"the closed form (or from sweep to sweep)")
    want = (n["rows3"] > 0 and n["rows"] > 0 and n["seq"] == 4
            if not skip_e2e else n["rows3"] > 0 and not n["rows"] + n["seq"])
    if not want:
        return fail(f"phase 18{label} launches: {json.dumps(n)}")
    return 0


# The two largest instances, built in child processes (each takes minutes
# of host time) while the phases before them run: (n_haps, length,
# coverage) of phases 6 and 15.
CHROM200 = (4, 200_000_000, 1.0)
CHROM46 = (49, 46_000_000, 2.0)
BUILDS: dict = {}


def start_build(shape) -> None:
    """Start a child process that builds eval.build_instance(*shape) into
    the script's instance cache and prints its wall."""
    code = ("import json, time\n"
            "t = time.time()\n"
            "from phi_tpu_torch.eval import build_instance\n"
            f"build_instance({shape[0]}, {shape[1]}, coverage={shape[2]})\n"
            "print(json.dumps({'wall': time.time() - t}))\n")
    BUILDS[shape] = subprocess.Popen(
        [sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def finish_build(shape):
    """Wait for shape's build; returns (paths, the child's wall s, s this
    process waited for it). Raises if the child failed."""
    t0 = time.time()
    proc = BUILDS.pop(shape)
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"building instance {shape} failed "
                           f"({proc.returncode}): {err[-2000:]}")
    from phi_tpu_torch.eval import build_instance
    paths = build_instance(shape[0], shape[1], coverage=shape[2])
    return paths, json.loads(out)["wall"], time.time() - t0


def stop_builds() -> None:
    """End every build child still running (the script failed early)."""
    for proc in BUILDS.values():
        proc.kill()
        proc.communicate()
    BUILDS.clear()


def model_line(label: str, model: dict, peak: int) -> str:
    """The memory model's total beside a measured peak, with their ratio
    and the model's stage sums."""
    return (f"{label}: memory model {model['total_bytes']} B (anchors "
            f"{model['stage_bytes']['anchors']} B, solve "
            f"{model['stage_bytes']['solve']} B, streamed W "
            f"{model['stream_w']}), measured peak {peak} B, model / peak "
            f"{model['total_bytes'] / peak:.3f} ({CARD})")


def same_occ(a, b) -> bool:
    """Two DeviceOcc with array-equal columns, in order, and equal stats."""
    import numpy as np
    import torch
    return (all(torch.equal(x, y) for x, y in (
        (a.dev_s, b.dev_s), (a.dev_span, b.dev_span), (a.dev_id, b.dev_id),
        (a.dev_hap, b.dev_hap)))
        and (a.n_occ, a.n_model, a.filtered, a.max_span, a.n_hits)
        == (b.n_occ, b.n_model, b.filtered, b.max_span, b.n_hits)
        and np.array_equal(a.per_hap_anchors, b.per_hap_anchors))


def phase15(dev, big, g49, launches, models, shape=CHROM46) -> int:
    """Phase 15: the JAX package's chromosome46 configuration (49 walks x
    46 Mbp, 2x reads, seed 0, -k 31 -w 25 -R 100; `shape` sets another
    length) through eval.onchip.run on `dev`; (c) the streamed solve and
    (d) the chunked filter held against the materialized solve and other
    chunk sizes; (e) the memory model beside the peaks of phases 4 and 6
    (`models`: label -> (model, peak)) and this one. Adds the runs'
    launches to `launches`. Returns 0, or 1 after a failure line."""
    import numpy as np
    import torch
    from phi_tpu_torch import pipeline
    from phi_tpu_torch.anchors import device as danchors
    from phi_tpu_torch.eval import onchip
    from phi_tpu_torch.eval.hbm_budget import budget_of_run
    from phi_tpu_torch.io.reads import load_read_batch
    t15 = time.time()

    # 15a: the instance, built by a child process meanwhile
    paths, built, waited = finish_build(shape)
    log(f"phase 15a: instance {shape} (haplotypes, length, coverage): "
        f"built in {built:.3f} s by a child process; waited {waited:.3f} "
        f"s for it ({CARD})")

    # 15b: eval.onchip.run, cold then warm; each run counted, and the
    # warm run's first solver tables and join inputs kept (only the
    # current run's: the runner frees a run's device handles before the
    # next)
    runs, cur = [], {}
    real_run, real_solve = pipeline.run_pipeline, pipeline.solve_dp
    real_join = pipeline.join_anchors_device

    def run_counted15(*args, **kwargs):
        cur.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.time()
        r = real_run(*args, **kwargs)
        torch.cuda.synchronize()
        runs.append((time.time() - t0, read_launches(),
                     torch.cuda.max_memory_allocated()))
        cur["result"] = r
        return r

    def solve_kept(t, *args, **kwargs):
        cur.setdefault("tables", (t, args))
        return real_solve(t, *args, **kwargs)

    def join_kept(*args, **kwargs):
        cur["join"] = (args, kwargs)
        return real_join(*args, **kwargs)

    pipeline.run_pipeline, pipeline.solve_dp = run_counted15, solve_kept
    pipeline.join_anchors_device = join_kept
    try:
        rec = onchip.run(*shape[:2], shape[2], 0, runs=2, lagrangian=8,
                         device=dev)
    finally:
        pipeline.run_pipeline, pipeline.solve_dp = real_run, real_solve
        pipeline.join_anchors_device = real_join
    log(f"phase 15b eval.onchip record: {json.dumps(rec)}")
    r = cur["result"]
    occ = r.anchors.device_occ
    for i, (wall, n, peak) in enumerate(runs):
        log(f"phase 15b run {i} ({'cold' if i == 0 else 'warm'}): wall "
            f"{wall:.3f} s, launches {json.dumps(n)}, peak device memory "
            f"{peak} B ({CARD})")
        if n["rows3"] <= 0 or n["rows2"] or n["rows"] or n["seq"]:
            return fail(f"phase 15b run {i}: launches {json.dumps(n)} (rows3 "
                        f"only)")
        launches["rows3"] += n["rows3"]
    truth = read_truth(paths)
    certified = report("phase 15b warm", r, runs[-1][0], runs[-1][1],
                       runs[-1][2], truth, 100.0)
    log(f"phase 15b: {occ.n_hits} join hits in {occ.n_chunks} finalize "
        f"chunks of {danchors.fin_chunk()}, {occ.n_occ} retained; walks of "
        f"{r.graph.walk_mat.shape[1]} positions; certified {certified}, gap "
        f"{rec['gap']}; {rec['recombinations']} recombinations against "
        f"{rec['true_breaks']} true breaks; edit distance "
        f"{rec['edit_distance']}; timings keys {sorted(r.timings)}")
    if len(runs) != 2 or not on_cuda(r) or occ is None:
        return fail("phase 15b: not two runs of the device path on cuda")
    if occ.n_chunks <= 1:
        return fail(f"phase 15b: {occ.n_hits} hits took {occ.n_chunks} "
                    f"finalize chunk at the default chunk")
    if rec["edit_distance"] > shape[1] // 1000:
        return fail(f"phase 15b: edit distance {rec['edit_distance']} to "
                    f"the truth (over 0.1% of the length)")
    models[f"phase 15 ({shape[1]} bp)"] = (
        budget_of_run(r, 31, 25), max(p for _, _, p in runs))

    # 15c: the warm run's first solve again, materialized and streamed
    tables, (max_sweeps, _) = cur["tables"]
    sols = {}
    try:
        for mode in ("0", "1"):
            os.environ["PHI_TPU_STREAM_W"] = mode
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            sols[mode] = pipeline.solve_dp(tables, max_sweeps, dev)
            torch.cuda.synchronize()
            log(f"phase 15c PHI_TPU_STREAM_W={mode}: solve_dp "
                f"{time.time() - t0:.3f} s, {sols[mode][2]} sweeps, "
                f"{tables.n_layers} layers, peak device memory "
                f"{torch.cuda.max_memory_allocated()} B ({CARD})")
    finally:
        os.environ.pop("PHI_TPU_STREAM_W", None)
    (m0, e0, s0, _), (m1, e1, s1, _) = sols["0"], sols["1"]
    equal = torch.equal(m0.M, m1.M) and np.array_equal(e0, e1) and s0 == s1
    log(f"phase 15c: streamed M [{tuple(m1.M.shape)}], ends and sweeps "
        f"bit-equal to the materialized solve's: {equal}")
    if not equal:
        return fail("phase 15c: the streamed solve differs")
    del sols, m0, m1, tables

    # 15d: the filter at other chunk sizes: 2^24 on these hits, 2^20 on
    # phase 4's (one chunk by default)
    jargs, jkw = cur["join"]
    seqs4 = [g49.walk_seq_codes(h) for h in range(g49.num_walks)]
    reads4 = load_read_batch(big["reads"])
    sp4 = pipeline.read_spectrum(reads4, 31, 25)
    cases = ((f"{shape[0]} x {shape[1]} bp", jargs, jkw, occ, 1 << 24),
             ("49 x 5 Mbp", (g49, seqs4, 31, 25, *sp4, 1.0), dict(device=dev),
              None, 1 << 20))
    try:
        for label, a, kw, want, chunk in cases:
            os.environ.pop("PHI_TPU_FIN_CHUNK", None)
            if want is None:
                want = danchors.join_anchors_device(*a, **kw)[1]
            os.environ["PHI_TPU_FIN_CHUNK"] = str(chunk)
            t0 = time.time()
            got = danchors.join_anchors_device(*a, **kw)[1]
            torch.cuda.synchronize()
            same = same_occ(got, want)
            log(f"phase 15d {label}: {want.n_hits} hits, {want.n_chunks} "
                f"chunk(s) by default and {got.n_chunks} of {chunk} "
                f"({time.time() - t0:.3f} s); DeviceOcc columns array-equal: "
                f"{same}")
            if not same or got.n_chunks == want.n_chunks:
                return fail(f"phase 15d {label}: the filter differs across "
                            f"chunk sizes, or took as many chunks")
            del got, want
    finally:
        os.environ.pop("PHI_TPU_FIN_CHUNK", None)

    # 17a: the warm run's join with 1 and with 3 pack workers
    if phase17a(jargs, jkw, r.anchors.per_hap_minimizers, occ):
        return 1

    # 15b, the card's busy share: the warm run once more under the profiler
    # (phi_tpu_torch.trace's method), over the unprofiled warm wall
    cur.clear()
    del r, occ
    from phi_tpu_torch.config import Options
    out = os.path.join(os.path.dirname(paths["gfa"]), "inferred_prof.fa")
    busy = profiled_busy(lambda: pipeline.run_pipeline(
        paths["gfa"], paths["reads"], out, Options(lagrangian_rounds=8),
        device=dev))
    log(f"phase 15b: card busy {busy:.3f} s of the profiled run, busy share "
        f"{busy / runs[-1][0]:.4f} of the warm wall {runs[-1][0]:.3f} s "
        f"({CARD})")

    # 15e: the memory model against the measured peaks
    for label, (model, peak) in models.items():
        log("phase 15e " + model_line(label, model, peak))
    log(f"phase 15: {time.time() - t15:.3f} s in all ({CARD})")
    return 0


def phase15_alone(dev, shape) -> int:
    """`--phase15 LENGTH`: phase 4's configuration once cold and once warm
    (its memory model and graph, which phase 15 reads), then phase 15 at
    49 walks x LENGTH. Prints no kernels or device JSON."""
    from phi_tpu_torch.eval import build_instance
    from phi_tpu_torch.eval.hbm_budget import budget_of_run
    big = build_instance(49, 5_000_000, coverage=1.0)
    out = os.path.join(os.path.dirname(big["gfa"]), "port_k31_alone.fa")
    flags = ["-k", "31", "-w", "25", "-R", "100"]
    for run in ("cold", "warm"):
        r, wall, n, peak = run_counted(big, out, flags, dev)
        report(f"phase 4 k=31 {run}", r, wall, n, peak, read_truth(big),
               100.0)
    launches = dict.fromkeys(KERNELS, 0)
    rc = phase15(dev, big, r.graph, launches,
                 {"phase 4": (budget_of_run(r, 31, 25), peak)}, shape)
    log(f"phase 15 alone at {shape}: exit {rc}, launches "
        f"{json.dumps(launches)}")
    return rc


# phase 16's panel: the MHC_4 panel's walk count at the CHM13 MHC
# haplotype's length (tests/test_eval.py:30), two held-out truths named as
# two of the reference's assemblies
GT_WALKS, GT_LENGTH = 5, 4_920_303
GT_SAMPLES = ("APD", "COX")
GT_DIR = os.path.join(BUILD, "gt")


def gt_build(d: str, n_haps: int = GT_WALKS, length: int = GT_LENGTH
             ) -> dict:
    """Phase 16's inputs into d, emptied first, from seed 0: a
    synth_pangenome panel (1% variant sites, 5% of them indels, 30 bp
    nodes) as panel.gfa, and for each of GT_SAMPLES a synthetic held-out truth (a 3-break mosaic of
    the walks with private SNPs at 5e-4, eval.scale's held-out recipe) as
    {sample}.fasta.gz; then each truth's floor, by panel_floor_cached into
    d/bench_results/.floors_cache.json (where run_grid reads it from the
    working directory d), with each walk's edit distance timed. Returns
    the build's wall and, by sample, the floor and the walks' times."""
    import gzip
    import shutil
    import numpy as np
    from phi_tpu_torch.eval import edits, groundtruth
    from phi_tpu_torch.eval.scale import mosaic_target
    from phi_tpu_torch.eval.synth import synth_pangenome
    from phi_tpu_torch.graph.pangenome import tensorize
    from phi_tpu_torch.io.gfa import read_gfa, write_gfa
    t0 = time.time()
    # an earlier run's floor cache would be hit and no walk timed; its
    # shards would be merged again
    shutil.rmtree(d, ignore_errors=True)
    rng = np.random.default_rng(0)
    graph, haps = synth_pangenome(rng, length=length, n_haps=n_haps,
                                  var_rate=0.01, indel_fraction=0.05)
    os.makedirs(d)
    panel = os.path.join(d, "panel.gfa")
    write_gfa(graph, path=panel)
    truths = {}
    for sample in GT_SAMPLES:
        truths[sample] = mosaic_target(rng, haps, length, 3, 5e-4)
        with gzip.open(os.path.join(d, f"{sample}.fasta.gz"), "wt") as f:
            f.write(f">{sample}\n")
            for i in range(0, len(truths[sample]), 80):
                f.write(truths[sample][i:i + 80] + "\n")
    out = {"build_s": time.time() - t0, "floors": {}}
    g = tensorize(read_gfa(panel))
    real, walk_s = edits.edit_stats, []

    def timed(a, b):
        t = time.time()
        st = real(a, b)
        walk_s.append(time.time() - t)
        return st

    edits.edit_stats = timed  # panel_floor imports it when called
    try:
        for sample in GT_SAMPLES:
            walk_s.clear()
            name, ed = groundtruth.panel_floor_cached(
                g, truths[sample], sample, panel,
                cache_path=os.path.join(d, "bench_results",
                                        ".floors_cache.json"))
            out["floors"][sample] = {"hap": name, "edit": ed,
                                     "walk_s": list(walk_s)}
    finally:
        edits.edit_stats = real
    return out


def start_gt_build() -> None:
    """Start a child process that runs gt_build(GT_DIR) and prints its
    JSON."""
    code = ("import json, chip_smoke\n"
            f"print(json.dumps(chip_smoke.gt_build({GT_DIR!r})))\n")
    BUILDS["gt"] = subprocess.Popen(
        [sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def finish_gt_build():
    """Wait for gt_build's child; returns (its JSON, s this process waited
    for it). Raises if the child failed."""
    t0 = time.time()
    proc = BUILDS.pop("gt")
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"building phase 16's panel failed "
                           f"({proc.returncode}): {err[-2000:]}")
    return json.loads(out.splitlines()[-1]), time.time() - t0


@contextlib.contextmanager
def cells_counted():
    """Wrap groundtruth.infer_cell for the block (run_grid and
    floor_diag.diagnose call it through the module): every call still
    runs, and its result, its pipeline runs (per_run's records), its wall
    and its DP solves and branch-and-bound calls (the certification
    ladder's work) are appended to the list the block gets."""
    from phi_tpu_torch import pipeline
    from phi_tpu_torch.eval import groundtruth
    from phi_tpu_torch.solve import bnb
    real, seen = groundtruth.infer_cell, []

    def wrapped(*args, **kwargs):
        t0 = time.time()
        with per_run() as runs, spy(pipeline, "_solve_and_decode") as solves, \
                spy(bnb, "branch_and_bound") as bnbs:
            out = real(*args, **kwargs)
        seen.append({"cell": out, "runs": runs, "wall": time.time() - t0,
                     "solves": len(solves), "bnb": len(bnbs)})
        return out

    groundtruth.infer_cell = wrapped
    try:
        yield seen
    finally:
        groundtruth.infer_cell = real


def cell_line(label: str, rec) -> str:
    """One infer_cell of cells_counted: its dict, and per pipeline run the
    wall, launches and peak device memory, with the card."""
    c = rec["cell"]
    runs = "; ".join(
        f"run {i} wall {run['wall']:.3f} s, peak {run['peak']} B, launches "
        f"{json.dumps(run['launches'])}" for i, run in enumerate(rec["runs"]))
    return (f"{label}: edit {c['edit']}, recombinations "
            f"{c['recombinations']}, gap {c['gap']}, escalated "
            f"{c['escalated']}, {c['n_reads']} reads; cell wall "
            f"{rec['wall']:.3f} s, {rec['solves']} DP solves, {rec['bnb']} "
            f"branch-and-bound; {runs} ({CARD})")


def phase16(dev, launches) -> int:
    """Phase 16 (a-f): the ground-truth accuracy chain on the card, at the
    MHC_4 panel's shape (GT_WALKS walks x GT_LENGTH bp, synthetic, from
    seed 0) with two synthetic held-out truths, cut by depth: (a) the
    floors, (b) run_grid under subs at 0.1-10x (APD) and 1, 10x (COX),
    indel and longread at 1, 10x (APD), (c) a forced escalation, (d)
    floor_diag.diagnose at 10x, (e) one cell on the CPU, (f) the merge of
    the grids' shards. Runs with GT_DIR as the working directory (the
    floors' default cache); adds its launches to `launches`. Returns 0, or
    1 after a failure line."""
    from phi_tpu_torch.eval import groundtruth
    t16 = time.time()
    built, waited = finish_gt_build()
    log(f"phase 16: {GT_WALKS} walks x {GT_LENGTH} bp (synth_pangenome, "
        f"seed 0) and the held-out truths {', '.join(GT_SAMPLES)}: "
        f"synthetic stand-ins for the reference's assemblies and the MHC_4 "
        f"panel, which the repo does not hold; built in "
        f"{built['build_s']:.3f} s by a child process, which then computed "
        f"the floors; waited {waited:.3f} s for it ({CARD})")
    saved_panel = groundtruth.PANEL_GFA
    # floor_diag reads the module's panel
    groundtruth.PANEL_GFA = os.path.join(GT_DIR, "panel.gfa")
    try:
        with contextlib.chdir(GT_DIR):
            rc = gt_phases(dev, launches, built)
    finally:
        groundtruth.PANEL_GFA = saved_panel
    log(f"phase 16: {time.time() - t16:.3f} s in all ({CARD})")
    return rc


def add_launches(launches: dict, n: dict) -> None:
    """Add the kernels that launched in `n` to `launches`."""
    for kern, c in n.items():
        if c:
            launches[kern] = launches.get(kern, 0) + c


def gt_floors(d: str, built: dict, n_walks: int = GT_WALKS) -> int:
    """Phase 16a: each truth's floor read back from gt_build's cache in d
    must be the one gt_build computed there, with n_walks walks timed.
    Returns 0, or 1 after a failure line."""
    from phi_tpu_torch.eval import groundtruth
    from phi_tpu_torch.graph.pangenome import tensorize
    from phi_tpu_torch.io.gfa import read_gfa
    panel = os.path.join(d, "panel.gfa")
    graph = tensorize(read_gfa(panel))
    for s in GT_SAMPLES:
        truth = groundtruth.load_truth(s, d)
        t0 = time.time()
        floor = groundtruth.panel_floor_cached(
            graph, truth, s, panel,
            cache_path=os.path.join(d, "bench_results", ".floors_cache.json"))
        hit = time.time() - t0
        child = built["floors"][s]
        log(f"phase 16a {s}: floor {floor[1]} edits ({floor[0]}) for a "
            f"{len(truth)} bp truth; panel_floor_cached computed it in "
            f"{sum(child['walk_s']):.3f} s in the build's child, per walk "
            f"{json.dumps([round(t, 3) for t in child['walk_s']])} s; read "
            f"back from its cache in {hit:.4f} s ({CARD})")
        if list(floor) != [child["hap"], child["edit"]] \
                or len(child["walk_s"]) != n_walks:
            return fail(f"phase 16a: {s}'s cached floor {floor} is not the "
                        f"one computed, {child}")
    return 0


def gt_phases(dev, launches, built: dict) -> int:
    """Phases 16a-f in the working directory GT_DIR (see phase16)."""
    import torch
    from phi_tpu_torch.eval import floor_diag, groundtruth, merge_gt, onchip
    from phi_tpu_torch.pipeline import gap_tol
    panel, tol = groundtruth.PANEL_GFA, gap_tol(100.0)
    # 16a: the floors (computed by the build's child; read from the cache)
    if gt_floors(GT_DIR, built):
        return 1
    truths = {s: groundtruth.load_truth(s, GT_DIR) for s in GT_SAMPLES}

    # 16b: the grids, one run_grid per (sample, error model)
    grids = [("APD", "subs", [0.1, 0.5, 1.0, 2.0, 5.0, 10.0]),
             ("COX", "subs", [1.0, 10.0]), ("APD", "indel", [1.0, 10.0]),
             ("APD", "longread", [1.0, 10.0])]
    results, cuda_cells = {}, {}
    slot0, n_runs = onchip.cache_counts()["pack_slot"], 0
    for sample, model, covs in grids:
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.time()
        with cells_counted() as cells:
            res = groundtruth.run_grid(
                samples=[sample], coverages=covs, seeds=1, gfa_path=panel,
                error_model=model, progress=False, device=dev,
                truth_dir=GT_DIR)
        wall, n = time.time() - t0, read_launches()
        add_launches(launches, n)
        results.setdefault(model, []).append((sample, res))
        log(f"phase 16b {sample} {model}: run_grid of {len(covs)} cells in "
            f"{wall:.3f} s, launches {json.dumps(n)} ({CARD})")
        if len(cells) != len(res["cells"]):
            return fail(f"phase 16b: {len(cells)} infer_cell calls for "
                        f"{len(res['cells'])} cells")
        for row, rec in zip(res["cells"], cells):
            label = f"phase 16b {sample} {model} {row['coverage']:g}x"
            log(cell_line(label, rec) + f"; floor {row['floor_edit']}, "
                f"beats it {row['beats_floor']}, certified "
                f"{row['certified']}")
            cuda_cells[(sample, model, row["coverage"])] = rec["cell"]
            n_runs += len(rec["runs"])
            for run in rec["runs"]:
                if run["launches"]["rows3"] <= 0 \
                        or not on_cuda(run["result"]):
                    return fail(f"{label}: a run launched no rows3 kernel "
                                f"or left the card")
            if not row["certified"]:
                log(f"{label}: not certified, gap {row['gaps']}")
            if row["coverage"] >= 2 \
                    and not row["edit_median"] < row["floor_edit"]:
                return fail(f"{label}: the mosaic's edit "
                            f"{row['edit_median']} does not beat the floor "
                            f"{row['floor_edit']}")

    # 17c: every grid run on the one panel after the first hits the slot
    slot = onchip.cache_counts()["pack_slot"]
    hits = slot["hits"] - slot0["hits"]
    log(f"phase 17c: {n_runs} pipeline runs on the panel in 16b: "
        f"{hits} packed-batch slot hits, {slot['stores'] - slot0['stores']} "
        f"stores")
    if hits != n_runs - 1:
        return fail(f"phase 17c: {hits} slot hits in {n_runs} runs on one "
                    f"panel")

    # 16c: a forced escalation restores the environment
    env = {k: v for k, v in os.environ.items() if k.startswith("PHI_TPU_")}
    zero_launches()
    with cells_counted() as cells:
        cell = groundtruth.infer_cell(panel, truths["APD"], 2.0, seed=7,
                                      escalate_tol=-1.0, device=dev)
    n = read_launches()
    add_launches(launches, n)
    rec = cells[0]
    log(cell_line("phase 16c forced escalation, APD subs 2x", rec)
        + f"; the escalated re-solve {rec['runs'][-1]['wall']:.3f} s")
    after = {k: v for k, v in os.environ.items() if k.startswith("PHI_TPU_")}
    if not cell["escalated"] or len(rec["runs"]) != 2 or after != env:
        return fail(f"phase 16c: escalated {cell['escalated']}, "
                    f"{len(rec['runs'])} runs, PHI_TPU_* before {env}, "
                    f"after {after}")
    if any(run["launches"]["rows3"] <= 0 for run in rec["runs"]):
        return fail("phase 16c: a run launched no rows3 kernel")

    # 16d: the R = 1 diagnosis at 10x
    zero_launches()
    t0 = time.time()
    with cells_counted() as cells:
        diag = floor_diag.diagnose(samples=("APD",), coverage=10.0,
                                   progress=False, device=dev,
                                   truth_dir=GT_DIR)
    wall, n = time.time() - t0, read_launches()
    add_launches(launches, n)
    for label, rec in zip(("production R=100", "oracle R=1"), cells):
        log(cell_line(f"phase 16d APD 10x {label}", rec))
    log(f"phase 16d: diagnose in {wall:.3f} s: {json.dumps(diag['rows'])}; "
        f"launches {json.dumps(n)} ({CARD})")
    if len(cells) != 2 or any(run["launches"]["rows3"] <= 0
                              for rec in cells for run in rec["runs"]):
        return fail("phase 16d: a run launched no rows3 kernel")

    # 16e: the APD 1x subs cell on the CPU equals the card's
    em = groundtruth.ERROR_MODELS["subs"]
    t0 = time.time()
    cpu = groundtruth.infer_cell(panel, truths["APD"], 1.0, seed=7,
                                 error_rate=em["error_rate"],
                                 read_len=em["read_len"],
                                 indel_rate=em["indel_rate"],
                                 escalate_tol=tol, device="cpu")
    keys = ("edit", "recombinations", "gap", "n_reads")
    want = cuda_cells[("APD", "subs", 1.0)]
    log(f"phase 16e: APD subs 1x on the CPU in {time.time() - t0:.3f} s: "
        f"{json.dumps(cpu)}; on cuda {json.dumps(want)}")
    if any(cpu[k] != want[k] for k in keys):
        return fail(f"phase 16e: the CPU cell differs from the card's in "
                    f"{[k for k in keys if cpu[k] != want[k]]}")

    # 16f: each grid's shards merged per error model
    parts = os.path.join(GT_DIR, "parts")
    for model, shards in results.items():
        for sample, res in shards:
            groundtruth.write_outputs(
                res, os.path.join(parts, f"{model}_{sample}"))
        with stderr_tee() as err:
            merged = merge_gt.merge(parts, model,
                                    os.path.join(GT_DIR, "merged", model))
        cells = [c for _, res in shards for c in res["cells"]]
        counts = [len(merged["cells"]),
                  sum(c["certified"] for c in merged["cells"]),
                  sum(c["beats_floor"] for c in merged["cells"])]
        missing = err.getvalue().count("[merge-gt] missing shard")
        log(f"phase 16f {model}: merged {counts[0]} cells, {counts[1]} "
            f"certified, {counts[2]} beat the floor; {missing} missing "
            f"shards (the reference's other samples)")
        if counts != [len(cells), sum(c["certified"] for c in cells),
                      sum(c["beats_floor"] for c in cells)] \
                or missing != len(groundtruth.SAMPLES) - len(shards) \
                or sorted(merged["floors"]) \
                != sorted(sample for sample, _ in shards):
            return fail(f"phase 16f {model}: the merge's counts {counts} "
                        f"or its {missing} missing shards do not add up")
    return 0


@contextlib.contextmanager
def env_set(**kv):
    """os.environ with the given variables set for the block, restored
    after it."""
    saved = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def batches_off():
    """No packed batches kept in a graph's memo for the block (its limit,
    graph.pangenome.BATCHES_MAX_BYTES, at 0), restored after it: every
    join packs and uploads every batch."""
    from phi_tpu_torch.graph import pangenome
    saved = pangenome.BATCHES_MAX_BYTES
    pangenome.BATCHES_MAX_BYTES = 0
    try:
        yield
    finally:
        pangenome.BATCHES_MAX_BYTES = saved


def join_spans(timings: dict) -> str:
    """The join's spans of a run's timings (the sketch_haps_* keys), as
    name=seconds."""
    n = len("sketch_haps_")
    return " ".join(f"{k[n:]}={v:.3f}" for k, v in timings.items()
                    if k.startswith("sketch_haps_"))


def phase17a(jargs, jkw, want_min, want) -> int:
    """Phase 17a: the warm chromosome run's join again, alone, with 1 pack
    worker and with the default 3, with no batches kept (batches_off; its
    batches pass the memo's limit anyway, as they do in the JAX package):
    per_hap_min and every DeviceOcc column array-equal across the two and
    to the warm run's, each wall, the join's spans and the card's busy
    share (a second call under torch.profiler, over the first call's
    wall); then the time of the walks' codes (walk_seq_codes), the part of
    sketch_haps outside the join. Returns 0, or 1 after a failure
    line."""
    import numpy as np
    import torch
    from phi_tpu_torch.anchors import device as danchors
    from phi_tpu_torch.trace import recording, span

    def join():
        out = danchors.join_anchors_device(*jargs, **jkw)
        torch.cuda.synchronize()
        return out

    walls = {}
    for workers in ("1", "3"):
        # no batches kept, so that both pack every batch at any size
        with env_set(PHI_TPU_PACK_WORKERS=workers), batches_off():
            zero_launches()
            with recording() as spans, span("sketch_haps"):
                t0 = time.time()
                got_min, got = join()
                walls[workers] = time.time() - t0
            n = read_launches()
        with env_set(PHI_TPU_PACK_WORKERS=workers), batches_off():
            busy = profiled_busy(join)
        same = np.array_equal(got_min, want_min) and same_occ(got, want)
        log(f"phase 17a PHI_TPU_PACK_WORKERS={workers}: join_anchors_device "
            f"wall {walls[workers]:.3f} s, busy {busy:.3f} s (share "
            f"{busy / walls[workers]:.4f}), launches {json.dumps(n)}; "
            f"per_hap_min and DeviceOcc columns equal to the warm run's: "
            f"{same} ({CARD}); spans: " + join_spans(spans))
        if not same or n["rows3"] <= 0:
            return fail(f"phase 17a: {workers} worker(s) gave other arrays "
                        f"or launched no rows3")
        del got_min, got
    log(f"phase 17a: 3 workers {walls['3']:.3f} s against 1 worker "
        f"{walls['1']:.3f} s ({walls['1'] / walls['3']:.3f}x) ({CARD})")
    # the rest of sketch_haps: the walks' codes, which the pipeline reads
    # before it joins
    graph = jargs[0]
    t0 = time.time()
    for h in range(graph.num_walks):
        graph.walk_seq_codes(h)
    log(f"phase 17a: the {graph.num_walks} walks' codes (walk_seq_codes, "
        f"outside the join) {time.time() - t0:.3f} s ({CARD})")
    return 0


def phase17b(big, dev, warm) -> int:
    """Phase 17b: phase 4 a third time, hitting the packed batches the
    cold run kept in the held graph's memo: the hit logged, the warm
    run's rows3 launches, its FASTA byte for byte, the join's spans,
    sketch_haps and solve_tables beside the warm run's; then once with no
    batches kept (batches_off), which packs and uploads every batch.
    `warm`: the warm run's (result, launches, FASTA path). Returns 0, or 1
    after a failure line."""
    from phi_tpu_torch.eval import onchip
    r_w, n_w, fa_w = warm
    flags = ["-k", "31", "-w", "25", "-R", "100"]
    rows = [("warm", r_w, None)]
    for label, off in (("third", False), ("slot off", True)):
        out = os.path.join(os.path.dirname(big["gfa"]),
                           f"port_k31_{label.replace(' ', '_')}.fa")
        before = onchip.cache_counts()
        with batches_off() if off else contextlib.nullcontext():
            r, wall, n, peak = run_counted(big, out, flags, dev)
        delta = onchip.cache_delta(before, onchip.cache_counts())
        same = same_file(out, fa_w)
        log(f"phase 17b {label}: wall {wall:.3f} s, peak {peak} B, "
            f"launches {json.dumps(n)}, FASTA == phase 4 warm: {same}; "
            f"caches {json.dumps(delta)} ({CARD}); spans: "
            + join_spans(r.timings))
        hits = delta["pack_slot"]["hits"]
        if not same or n["rows3"] != n_w["rows3"] \
                or hits != (1 if label == "third" else 0):
            return fail(f"phase 17b {label}: {hits} slot hits, launches "
                        f"{json.dumps(n)} against {json.dumps(n_w)}, FASTA "
                        f"equal {same}")
        rows.append((label, r, delta))
    for label, r, _ in rows:
        t = r.timings
        log(f"phase 17b {label}: sketch_haps {t['sketch_haps']:.4f} s, "
            f"solve_tables {t.get('solve_tables', 0.0):.4f} s, solve "
            f"{t['solve']:.4f} s ({CARD})")
    return 0


def rechop_copy(src: str, dst: str) -> None:
    """A copy of a GFA (forward S, L and W lines, as write_gfa gives them)
    with every segment of two or more bases cut in two at its middle: the
    same walk sequences on another node chop."""
    with open(src) as f:
        rows = [ln.split("\t") for ln in f.read().splitlines()]
    parts = {}   # segment -> its pieces, in walk order
    out = []
    for p in rows:
        if p[0] == "S" and len(p[2]) >= 2:
            m = len(p[2]) // 2
            parts[p[1]] = (f"{p[1]}_a", f"{p[1]}_b")
            out += [["S", f"{p[1]}_a", p[2][:m]], ["S", f"{p[1]}_b", p[2][m:]],
                    ["L", f"{p[1]}_a", "+", f"{p[1]}_b", "+", "0M"]]
        elif p[0] in ("S", "H"):
            if p[0] == "S":
                parts[p[1]] = (p[1],)
            out.append(p)
    for p in rows:
        if p[0] == "L":
            out.append(["L", parts[p[1]][-1], p[2], parts[p[3]][0]] + p[4:])
        elif p[0] == "W":
            walk = "".join(">" + ">".join(parts[n])
                           for n in p[6][1:].split(">"))
            out.append(p[:6] + [walk])
        elif p[0] not in ("S", "H"):
            out.append(p)
    with open(dst, "w") as f:
        f.write("\n".join("\t".join(p) for p in out) + "\n")


def phase17d(small, dev) -> int:
    """Phase 17d: phase 3's graph, then a copy of it on another node chop
    (rechop_copy): two graphs, so the copy packs and keeps its own
    batches, its per-walk minimizer counts equal the first's (the same
    walk sequences), and its DeviceOcc equals a run of it after its
    graph is released. Returns 0, or 1 after a failure line."""
    import numpy as np
    from phi_tpu_torch import pipeline
    from phi_tpu_torch.anchors import device as danchors
    from phi_tpu_torch.eval import onchip
    from phi_tpu_torch.graph.pangenome import tensorize
    from phi_tpu_torch.io.gfa import read_gfa
    from phi_tpu_torch.io.reads import load_read_batch
    other = os.path.join(os.path.dirname(small["gfa"]), "rechop.gfa")
    rechop_copy(small["gfa"], other)
    sp = pipeline.read_spectrum(load_read_batch(small["reads"]), 31, 25)
    graphs = [tensorize(read_gfa(p)) for p in (small["gfa"], other)]

    def join(g):
        seqs = [g.walk_seq_codes(h) for h in range(g.num_walks)]
        return danchors.join_anchors_device(g, seqs, 31, 25, *sp, 1.0,
                                            device=dev)

    zero_launches()
    first = join(graphs[0])
    before = onchip.cache_counts()
    second = join(graphs[1])
    delta = onchip.cache_delta(before, onchip.cache_counts())
    graphs[1].release()
    cold = join(graphs[1])
    n = read_launches()
    same_min = np.array_equal(first[0], second[0])
    log(f"phase 17d: {graphs[0].n_vtx} nodes re-chopped into "
        f"{graphs[1].n_vtx}; the copy's join: caches {json.dumps(delta)}, "
        f"per-walk minimizers == phase 3's graph's {same_min}, DeviceOcc "
        f"== a cold run's {same_occ(second[1], cold[1])}; launches "
        f"{json.dumps(n)} ({CARD})")
    if delta["pack_slot"]["hits"] \
            or delta["pack_slot"]["stores"] != 1 or not same_min \
            or not same_occ(second[1], cold[1]):
        return fail("phase 17d: the re-chopped graph hit the slot or its "
                    "join differs")
    return 0


def phase16_csv(matrix_csv: str, main_edit: int) -> int:
    """Phase 16g, after phase 13: phase 13b's matrix CSV through
    plots.read_matrix_csv (its reads, coverages and the 1x edit); no
    figure is drawn. Returns 0, or 1 after a failure line."""
    import importlib.util
    from phi_tpu_torch.eval import plots
    reads, covs, csv_cells = plots.read_matrix_csv(matrix_csv)
    log(f"phase 16g: read_matrix_csv of phase 13's matrix.csv: reads "
        f"{reads}, coverages {covs}, cells "
        f"{json.dumps({f'{r} {c}': v for (r, c), v in csv_cells.items()})}; "
        f"figures are not drawn (matplotlib "
        f"{'present' if importlib.util.find_spec('matplotlib') else 'absent'}"
        f" on this machine; the smoke draws none)")
    if reads != ["sim"] or sorted(covs) != ["0.1x", "1x"] \
            or csv_cells[("sim", "1x")][2] != main_edit:
        return fail(f"phase 16g: the CSV holds {reads} x {covs}, not phase "
                    f"13b's cells with its 1x edit {main_edit}")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    alone = None
    if argv:
        if len(argv) != 2 or argv[0] != "--phase15" or not argv[1].isdigit():
            return fail("usage: python3 chip_smoke.py [--phase15 LENGTH]")
        alone = (CHROM46[0], int(argv[1]), CHROM46[2])
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
    global CARD
    CARD = card
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, devices {torch.cuda.device_count()}")
    if not native_available():
        return fail("native host library unavailable (make -C native)")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    # phase 15's instance starts building once phase 6's is done: the two
    # builds side by side slow the one phase 6 waits for; phase 16's panel
    # (a light build, then the floors' native edit distances) starts now,
    # and phase 16 runs while phase 6's instance builds
    builds = f"the instance {alone or CHROM200} (haplotypes, length, coverage)"
    if not alone:
        start_gt_build()
        builds += " and phase 16's panel"
    start_build(alone or CHROM200)
    log(f"building {builds} in child processes meanwhile")

    # --- phase 1: build ---
    from phi_tpu_torch.sketch import kernels as tk
    t0 = time.time()
    stage_build = start_stage_build()
    tk.build_rows()
    stage_lib = stage_library(stage_build)
    log(f"rows kernels ({', '.join(KERNELS)}) and their stage cuts "
        f"built in {time.time() - t0:.3f} s ({card})")
    ptxas = ptxas_report(tk.build_log())
    for n in KERNELS:
        used, spill = ptxas.get(n, ("not found", ""))
        log(f"ptxas {n}: {used}; {spill}; {tk.occupancy(n)} resident "
            f"blocks per SM")
        if not used or spills(spill):
            return fail(f"ptxas: {n} spills registers or has no report")

    if alone:
        return phase15_alone(dev, alone)

    # --- phase 2: each kernel vs its twin at the production shape ---
    sb = tk.SUPER_BLOCKS
    err = dict.fromkeys(KERNELS, 0)
    ms, plain_ms, bound = {}, {}, {}

    def check(name, args, *params):
        err[name] = max(err[name], compare(name, args, *params))

    def timed(name, args, *params):
        check(name, args, *params)
        kern = getattr(tk, f"sketch_{name}")
        ms[name] = cuda_ms(lambda: kern(*args, *params))
        plain_ms[name] = cuda_ms(lambda: getattr(tk, f"sketch_{name}_torch")(
            *args, *params))
        bound[name] = bound_ms(name, args, kern(*args, *params), params[1])
        log(f"{name} {params} codes {tuple(args[0].shape)}: equal to twin; "
            f"kernel {ms[name]:.4f} ms, twin {plain_ms[name]:.4f} ms (median "
            f"of 10 samples, {card}); bound {bound[name][0]:.4f} ms "
            f"({bound[name][1]}), {bound[name][0] / ms[name]:.1%} reached")

    def profiled(name, args, *params):
        """timed, then the median of 10 timings of 5 calls each (the
        wrapper's host time hidden behind the card's queue) and the stage
        split."""
        timed(name, args, *params)
        kern = getattr(tk, f"sketch_{name}")
        m5 = median(cuda_times(lambda: kern(*args, *params), inner=5))
        log(f"{name} {params}: {m5:.4f} ms with 5 calls per pair of events "
            f"({bound[name][0] / m5:.1%} of bound; median of 10, {card})")
        split = stage_split(stage_lib, name, args, *params)
        log(f"{name} {params} stage split (ms, medians of 20 in turns, 5 "
            f"calls per pair of events, {card}): {json.dumps(split)}")

    args = rows_inputs(1, sb)
    profiled("rows3", args, 31, 25, tk.block_cap(25))
    profiled("rows3w", args, 35, 25, tk.block_cap(25))
    profiled("rows2", args, 31, 25)
    pos_args = (args[0], args[2], args[3])
    profiled("rows", pos_args, 31, 25)
    check("rows", pos_args, 21, 11)
    import numpy as np
    rng = np.random.default_rng(8)
    seq_args = tk._seq_tensors(
        seq_with_n(rng.integers(0, 4, 5_000_000, dtype=np.uint8), rng),
        31, 25, dev)
    profiled("seq", seq_args, 31, 25)
    args = rows_inputs(2, sb)
    check("rows3", args, 21, 11, tk.block_cap(11))
    check("rows3", args, 21, 11, 256)
    check("rows3w", args, 63, 11, tk.block_cap(11))
    cnt = tk.sketch_rows3(*args, 21, 11, 256)[2]
    if not bool((cnt > 256).any()):
        return fail("the cnt > C case did not overflow C")
    log(f"rows3 k=21 w=11 (C={tk.block_cap(11)} and C=256, max cnt "
        f"{int(cnt.max())}) and rows3w k=63 w=11: equal to twin")
    edge = edge_inputs(3)
    edge_pos = (edge[0], edge[2], edge[3])
    narrow_kw = ((31, 25), (31, 99), (21, 1), (15, 16), (20, 33), (20, 34))
    for k, w in narrow_kw:
        check("rows2", edge, k, w)
        check("rows3", edge, k, w, tk.block_cap(w))
        check("rows", edge_pos, k, w)
    check("rows3", edge, 21, 11, 64)
    for k, w, C in ((35, 25, tk.block_cap(25)), (63, 67, tk.block_cap(67)),
                    (40, 1, tk.BLK), (32, 11, 64), (40, 34, tk.block_cap(34))):
        check("rows3w", edge, k, w, C)
    for kern, cnt in (("rows3", tk.sketch_rows3(*edge, 21, 11, 64)[2]),
                      ("rows3w", tk.sketch_rows3w(*edge, 32, 11, 64)[3])):
        if not bool((cnt > 64).any()):
            return fail(f"the {kern} cnt > C edge case did not overflow C")
    seq_kw = ((31, 25), (21, 1), (31, 99))
    for kind in SEQ_EDGES:
        for k, w in seq_kw:
            check("seq", tk._seq_tensors(seq_edge_codes(kind, k, w), k, w,
                                         dev), k, w)
    log(f"rows2, rows3 and rows equal to twin on the edge rows (k, w) = "
        f"{', '.join(map(str, narrow_kw))}, and rows3 "
        f"(21, 11) with C = 64; rows3w (35, 25), (63, 67), (40, 1), (32, 11) "
        f"with C = 64, (40, 34); seq on N at {', '.join(SEQ_EDGES)}, (k, w) "
        f"= {', '.join(map(str, seq_kw))}")

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

    # --- phase 17d: another node chop of phase 3's graph misses the slot ---
    if phase17d(small, dev):
        return 1

    # --- phases 4 and 5: the main path at size, k = 31 and wide k = 35 ---
    from phi_tpu_torch.eval import edit_stats
    t0 = time.time()
    big = build_instance(49, 5_000_000, coverage=1.0)
    log(f"instance 49 x 5 Mbp, 1x: ready in {time.time() - t0:.1f} s "
        f"({card})")
    truth = read_truth(big)
    from phi_tpu_torch.eval.hbm_budget import budget_of_run
    launches, models = {}, {}
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
            if phase == 4 and run == "warm":
                main_edit = edit_stats(r.sequence, truth).edit_distance
                main_report = (r.report_segments, r.recombination_count)
                models["phase 4"] = (budget_of_run(r, 31, 25), peak)
                # --- phase 17b: a third run, from the packed-batch slot ---
                if phase17b(big, dev, (r, n, out)):
                    return 1
        for args in instance_batches(r, k, 25, dev, False):
            check(kern, args, k, 25, tk.block_cap(25))
        log(f"{kern} equal to twin on the 49 x 5 Mbp instance's first 2 "
            f"batches (k={k})")

    # --- phase 16 (a-f): the ground-truth chain at the MHC_4 panel's
    # shape, while phase 6's instance builds ---
    if phase16(dev, launches):
        return 1

    # --- phase 6: the v2 mixed route at chromosome length ---
    from phi_tpu_torch.ops.search import CUCKOO_MAX_KEYS
    chrom, built, waited = finish_build(CHROM200)
    start_build(CHROM46)
    log(f"instance 4 x 200 Mbp, 1x: built in {built:.3f} s by a child "
        f"process started with the script; waited {waited:.3f} s for it "
        f"({card}); building {CHROM46} in a child process meanwhile")
    out = os.path.join(os.path.dirname(chrom["gfa"]), "port.fa")
    r, wall, n, peak = run_counted(chrom, out,
                                   ["-k", "31", "-w", "25", "-R", "100"], dev)
    certified = report("phase 6 v2 mixed", r, wall, n, peak,
                       read_truth(chrom), 100.0)
    launches["rows2"] = n["rows2"]
    models["phase 6"] = (budget_of_run(r, 31, 25), peak)
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

    # --- phase 7: the checkpoint on the 49 x 5 Mbp instance ---
    from phi_tpu_torch.checkpoint import load_index
    bdir = os.path.dirname(big["gfa"])
    idx = os.path.join(bdir, "port_index.npz")
    main_fa = os.path.join(bdir, "port_k31_warm.fa")
    flags = ["-k", "31", "-w", "25", "-R", "100"]
    phase7 = (("7a save-index", "save.fa", flags + ["--save-index", idx]),
              ("7b load-index", "load.fa", flags + ["--load-index", idx]),
              ("7c load-index -R 50", "load_r50.fa",
               ["-k", "31", "-w", "25", "-R", "50", "--load-index", idx]),
              ("7c default -R 50", "default_r50.fa",
               ["-k", "31", "-w", "25", "-R", "50"]))
    fa = {}
    for label, fname, argv in phase7:
        fa[label] = os.path.join(bdir, f"port_{fname}")
        r, wall, n, peak = run_counted(big, fa[label], argv, dev)
        R = float(argv[argv.index("-R") + 1])
        if not report(f"phase {label}", r, wall, n, peak, truth, R):
            return fail(f"phase {label}: not certified")
        if not on_cuda(r):
            return fail(f"phase {label}: solver tensors are not on cuda")
        if label == "7a save-index":
            launches["rows"] = n["rows"]
            if n["rows"] <= 0 or n["rows3"] != 0:
                return fail(f"--save-index launches: {json.dumps(n)}")
            _, hits, _ = load_index(idx)
            log(f"phase 7a: index {os.path.getsize(idx)} B, "
                f"{sum(len(h[1]) for h in hits)} join hits, "
                f"{sum(h[0] for h in hits)} minimizers")
            save_run = r
        elif label != "7c default -R 50" and any(n.values()):
            return fail(f"{label} launched a rows kernel: {json.dumps(n)}")
    for a, b in (("7a save-index", None), ("7b load-index", None),
                 ("7c load-index -R 50", "7c default -R 50")):
        if not same_file(fa[a], fa[b] if b else main_fa):
            return fail(f"phase {a}: FASTA differs from "
                        f"{b or 'phase 4 (warm)'}")
    log("phase 7: save-index and load-index FASTA == phase 4 warm FASTA; "
        "load-index -R 50 FASTA == default -R 50 FASTA")
    for args in join_batches(save_run, 31, 25, dev):
        check("rows", args, 31, 25)
    log("rows equal to twin on the 49 x 5 Mbp instance's first 2 v1 batches")

    # --- phase 8: the single-sequence kernel at size ---
    spectrum, hits, _ = load_index(idx)
    hap0 = save_run.graph.walk_seq_codes(0)
    with_n = seq_with_n(hap0, np.random.default_rng(9))
    zero_launches()
    t0 = time.time()
    s_hi, _, s_pos = tk.sketch_sequence(with_n, 31, 25, device=dev)
    got = tk.join_sequence(hap0, 31, 25, *spectrum, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches["seq"] = tk.sketch_seq.launches
    if launches["seq"] != 2 or tk.sketch_rows.launches:
        return fail(f"phase 8 launches: seq {launches['seq']}, rows "
                    f"{tk.sketch_rows.launches}")
    want = tk.join_many([hap0], 31, 25, *spectrum, device=dev)[0]
    if (got[0] != want[0] or not np.array_equal(got[1], want[1])
            or not np.array_equal(got[2], want[2])
            or not np.array_equal(got[1], hits[0][1])):
        return fail("phase 8: join_sequence differs from join_many on "
                    "haplotype 0")
    check("seq", tk._seq_tensors(with_n, 31, 25, dev), 31, 25)
    log(f"phase 8: haplotype 0 ({len(hap0)} bp): sketch_sequence with N "
        f"runs {len(s_hi)} minimizers (positions {int(s_pos.min())}.."
        f"{int(s_pos.max())}), join_sequence {got[0]} minimizers and "
        f"{len(got[1])} hits == join_many; both in {wall:.3f} s ({card}); "
        f"seq equal to twin on the N-bearing haplotype")

    # --- phase 9: the host hit path on the 49 x 5 Mbp instance ---
    n_paths = dict(big, gfa=os.path.join(bdir, "graph_n.gfa"))
    node, holders = n_walk_copy(save_run.graph, big["gfa"], n_paths["gfa"])
    log(f"phase 9a: N run written into node {node}, held by "
        f"{len(holders)} of {save_run.graph.num_walks} walks "
        f"({holders[:8]}...)")
    r, wall, n, peak = run_counted(n_paths, os.path.join(bdir, "port_n.fa"),
                                   flags, dev)
    report("phase 9a N walks", r, wall, n, peak, truth, 100.0)
    if n["rows"] <= 0 or n["rows3"] != 0 or not on_cuda(r):
        return fail(f"phase 9a launches: {json.dumps(n)}")
    for h in range(save_run.graph.num_walks):
        if h in holders:
            continue
        a, b = r.hits[h], hits[h]
        if (a[0] != b[0] or not np.array_equal(a[1], b[1])
                or not np.array_equal(a[2], b[2])):
            return fail(f"phase 9a: walk {h} (no N) differs from the phase "
                        f"7a index")
    log(f"phase 9a: the {save_run.graph.num_walks - len(holders)} walks "
        f"without N have the phase 7a index's minimizer counts, hit "
        f"positions and ids")
    idx35 = os.path.join(bdir, "port_index_k35.npz")
    phase9 = (("9b k=35 save-index", "k35_save.fa",
               ["-k", "35", "-w", "25", "-R", "100", "--save-index", idx35]),
              ("9c k=31 w=100", "w100.fa", ["-k", "31", "-w", "100", "-R",
                                            "100"]))
    for label, fname, argv in phase9:
        out = os.path.join(bdir, f"port_{fname}")
        r, wall, n, peak = run_counted(big, out, argv, dev)
        report(f"phase {label}", r, wall, n, peak, truth, 100.0)
        if any(n.values()) or r.hits is None or not on_cuda(r):
            return fail(f"phase {label}: not the host join of every walk "
                        f"(launches {json.dumps(n)})")
        if not os.path.exists(out):
            return fail(f"phase {label}: no FASTA")
    if not same_file(os.path.join(bdir, "port_k35_save.fa"),
                     os.path.join(bdir, "port_k35_warm.fa")):
        return fail("phase 9b: FASTA differs from phase 5 (warm)")
    log("phase 9: 9b FASTA == phase 5 warm FASTA; 9c wrote its FASTA")

    # --- phase 10: a chain of 80 empty nodes, the bracket solve ---
    from phi_tpu_torch import pipeline
    # the same file name as the instance's graph: the FASTA header names it
    chain_paths = dict(big, gfa=os.path.join(bdir, "chain", "graph.gfa"))
    node, holders = chain_copy(save_run, chain_paths["gfa"])
    log(f"phase 10: 80 empty segments after node {node}, in the "
        f"{len(holders)} walks that visit it")
    chain_fa = os.path.join(bdir, "port_chain.fa")
    with stderr_tee() as said, spy(pipeline, "solve_dp_both") as calls:
        r, wall, n, peak = run_counted(chain_paths, chain_fa, flags, dev)
    certified = report("phase 10 chain", r, wall, n, peak, truth, 100.0)
    bracket = [out for _, out in calls]
    span = int((r.anchors.occ_end - r.anchors.occ_start).max())
    same = same_file(chain_fa, main_fa)
    log(f"phase 10: max span {span} walk positions; {len(bracket)} bracket "
        f"solves on {sorted({b[0][0].M.device.type for b in bracket})}, "
        f"sweeps {max((b[2] for b in bracket), default=0)} (the chosen "
        f"path's {r.decode.n_sweeps}); bound {r.decode.dp_objective:.3f}, "
        f"objective {r.decode.true_objective:.3f}, certified {certified}; "
        f"FASTA == phase 4 warm FASTA: {same}")
    if "spans past 63 walk positions" not in said.getvalue():
        return fail("phase 10: the device anchors did not hand over")
    if n["rows"] <= 0 or n["rows3"] != 0:
        return fail(f"phase 10 launches: {json.dumps(n)}")
    if not bracket or not on_cuda(r) or any(
            b[0][0].M.device.type != "cuda" for b in bracket):
        return fail("phase 10: no bracket solve, or solver tensors not on "
                    "cuda")
    if certified and not same:
        return fail("phase 10: certified, but the FASTA differs from phase 4")

    # --- phase 11: -d 1 and --race on through the CLI ---
    dbg_fa = os.path.join(bdir, "port_debug.fa")
    rc, r, wall, n, peak, said = cli_counted(
        ["-g", big["gfa"], "-r", big["reads"], "-o", dbg_fa] + flags
        + ["-d", "1", "--race", "on"])
    if rc != 0 or r is None:
        return fail(f"phase 11: the CLI exited {rc}")
    report("phase 11 -d 1 --race on", r, wall, n, peak, truth, 100.0)
    lines = debug_lines(said)
    hist = [float(ln.split(": ")[-1].rstrip("]")) for ln in lines
            if ln.startswith("[Haplotypes:")]
    n_seg = sum(ln.startswith("[D] segment") for ln in lines)
    log(f"phase 11: {len(lines)} debug lines, {n_seg} [D] segment lines, "
        f"histogram over {len(hist)} walks sums to {sum(hist):.6f}; "
        f"{n['seq']} seq launches")
    if abs(sum(hist) - 1.0) > 1e-4 or len(hist) != r.graph.num_walks:
        return fail("phase 11: the sharing histogram does not sum to 1")
    if not any("model dump skipped (too large)" in ln for ln in lines):
        return fail("phase 11: no model dump summary line")
    if "--race on: no effect" not in said or n_seg < 1:
        return fail("phase 11: no --race line or no [D] segment line")
    if n["seq"] != r.graph.num_walks:
        return fail(f"phase 11: {n['seq']} seq launches for "
                    f"{r.graph.num_walks} walks")
    if not same_file(dbg_fa, main_fa):
        return fail("phase 11: FASTA differs from phase 4 (warm)")
    small_lines = {}
    for d in ("cuda", "cpu"):
        out = os.path.join(os.path.dirname(small["gfa"]), f"port_d_{d}.fa")
        rc, _, _, _, _, said = cli_counted(
            ["-g", small["gfa"], "-r", small["reads"], "-o", out, "-d", "1",
             "--device", d])
        small_lines[d] = debug_lines(said)
        if rc != 0:
            return fail(f"phase 11: the small -d 1 run on {d} exited {rc}")
    if small_lines["cuda"] != small_lines["cpu"]:
        return fail("phase 11: the small instance's debug lines differ "
                    "between cuda and cpu")
    log(f"phase 11: FASTA == phase 4 warm FASTA; small 4x200kbp: "
        f"{len(small_lines['cuda'])} debug lines, cuda == cpu")

    # --- phase 12: VCF ingest at MHC scale ---
    from phi_tpu_torch.eval.synth import sample_reads
    vdir = os.path.join(BUILD, "scale", "vcf_24x2_5M")
    os.makedirs(vdir, exist_ok=True)
    vpaths = {"gfa": os.path.join(vdir, "graph.gfa"),
              "reads": os.path.join(vdir, "reads.fa")}
    ref_fa, vcf = os.path.join(vdir, "ref.fa"), os.path.join(vdir, "v.vcf")
    t0 = time.time()
    ref, records = write_vcf(ref_fa, vcf, 5_000_000, 24, seed=0)
    t_vcf = time.time() - t0
    t0 = time.time()
    with open(vpaths["gfa"], "w") as f:
        conv = subprocess.run(
            [sys.executable, "-m", "phi_tpu_torch.vcfio.vcf2graph", "-v", vcf,
             "-r", ref_fa], stdout=f, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, timeout=600)
    t_conv = time.time() - t0
    if conv.returncode != 0:
        return fail(f"phase 12: vcf2graph exited {conv.returncode}: "
                    f"{conv.stderr[-2000:]}")
    haps = [realize(ref, records, h) for h in (3, 40)]
    m = min(map(len, haps))
    reads, target = sample_reads(
        np.random.default_rng(12), [h[:m] for h in haps], coverage=1.0,
        read_len=150, error_rate=0.002,
        recomb_breaks=[(m // 3, 1), (2 * m // 3, 0)])
    with open(vpaths["reads"], "w") as f:
        f.writelines(f">r{i}\n{s}\n" for i, s in enumerate(reads))
    log(f"phase 12: {len(records)} VCF records, 24 samples, written in "
        f"{t_vcf:.3f} s; vcf2graph {t_conv:.3f} s ({card}), GFA "
        f"{os.path.getsize(vpaths['gfa'])} B; {len(reads)} reads of a "
        f"2-switch mosaic of S1.1 and S20.0")
    r, wall, n, peak = run_counted(vpaths, os.path.join(vdir, "port.fa"),
                                   flags, dev)
    certified = report("phase 12 VCF", r, wall, n, peak, target, 100.0)
    log(f"phase 12: {r.graph.num_walks} walks, {r.graph.n_vtx} nodes; "
        f"certified {certified}")
    if r.graph.num_walks != 49 or n["rows3"] <= 0 or not on_cuda(r):
        return fail(f"phase 12: {r.graph.num_walks} walks, launches "
                    f"{json.dumps(n)}")
    if not certified:
        return fail("phase 12: the VCF run is not certified")

    # --- phase 13: the eval runners at size, on the phase-4 instance ---
    if phase13(big, dev, main_fa, main_edit, save_run.graph, launches):
        return 1

    # --- phase 14: the mesh and the device read sketch on the card ---
    if phase14(big, chrom, small, dev, main_fa, main_report,
               os.path.join(os.path.dirname(small["gfa"]), "port_cuda.fa"),
               launches):
        return 1

    # --- phase 18a: the mesh's collectives, 49 x 5 Mbp end to end ---
    if phase18("a", dev, (49, 5_000_000, 1.0), launches, skip_e2e=False):
        return 1

    # --- phase 15: chromosome scale, 49 x 46 Mbp ---
    if phase15(dev, big, save_run.graph, launches, models):
        return 1

    # --- phase 18b: the mesh's collectives, 49 x 46 Mbp, the solve ---
    if phase18("b", dev, CHROM46, launches, skip_e2e=True):
        return 1

    # --- phase 16g: phase 13's matrix CSV read back ---
    if phase16_csv(os.path.join(os.path.dirname(big["gfa"]), "matrix.csv"),
                   main_edit):
        return 1

    replaces = {"rows3": 1000, "rows3w": 1340, "rows2": 688, "rows": 237,
                "seq": 57}
    print(json.dumps({"kernels": [{
        "name": n, "route": "cuda", "source": "phi_tpu_torch/csrc/rows.cu",
        "replaces": f"phi_tpu/sketch/kernels.py:{replaces[n]}",
        "launches": launches[n], "max_abs_err": err[n],
        "ms": ms[n], "plain_ms": plain_ms[n], "bound_ms": bound[n][0],
        "bound_by": bound[n][1], "library_ms": None} for n in KERNELS]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_builds()
    sys.exit(code)
