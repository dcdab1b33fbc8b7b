#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (phi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

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
     haplotypes through the rows3 route at -k 31 -w 25 -R 100; certified.
Phases 4-12 set every kernel's launch count to 0 just before each run and
read them just after. The second-to-last line is the kernels JSON, the
last the device JSON. Instances are generated from a seed into
phi_tpu_torch/_build/scale/.
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


def run_port(paths, out, argv, device):
    """One run through the CLI's options; -r is passed on --load-index runs
    too (the reads are not read then), so the FASTA record name is the
    same as the other runs'."""
    from phi_tpu_torch import cli
    from phi_tpu_torch.pipeline import run_pipeline
    opt = cli.options_from_args(cli.build_parser().parse_args(
        ["-g", paths["gfa"], "-r", paths["reads"], "-o", out] + argv))
    return run_pipeline(paths["gfa"], paths["reads"], out, opt, device=device)


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
    return value is appended to the list the block gets."""
    real, seen = getattr(module, name), []

    def wrapped(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out)
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
    from phi_tpu_torch.sketch import kernels as tk
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for n in KERNELS:
        getattr(tk, f"sketch_{n}").launches = 0
    t0 = time.time()
    with stderr_tee() as err, spy(pipeline, "run_pipeline") as runs:
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {n: getattr(tk, f"sketch_{n}").launches for n in KERNELS}
    return (rc, runs[0] if runs else None, wall, launches,
            torch.cuda.max_memory_allocated(), err.getvalue())


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
    global CARD
    CARD = card
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, devices {torch.cuda.device_count()}")
    if not native_available():
        return fail("native host library unavailable (make -C native)")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

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

    # --- phases 4 and 5: the main path at size, k = 31 and wide k = 35 ---
    t0 = time.time()
    big = build_instance(49, 5_000_000, coverage=1.0)
    log(f"instance 49 x 5 Mbp, 1x: ready in {time.time() - t0:.1f} s "
        f"({card})")
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
    log(f"instance 4 x 200 Mbp, 1x: ready in {time.time() - t0:.1f} s "
        f"({card})")
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
    for n in KERNELS:
        getattr(tk, f"sketch_{n}").launches = 0
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
    with stderr_tee() as said, spy(pipeline, "solve_dp_both") as bracket:
        r, wall, n, peak = run_counted(chain_paths, chain_fa, flags, dev)
    certified = report("phase 10 chain", r, wall, n, peak, truth, 100.0)
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
    sys.exit(main())
