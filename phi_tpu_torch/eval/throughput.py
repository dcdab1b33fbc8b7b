"""Sketch/join throughput micro-benchmark (BASELINE.md north-star: read
k-mer throughput, k-mers/s per device): the port's copy of
`phi_tpu/eval/throughput.py`.

Measures:
  * `sketch` — minimizer extraction over a read-shaped concatenation
               (the reference's hot loops #1/#2, ILP_index.cpp:359-493)
               through `sketch.minimizer.sketch_read_concat`: the native
               host scan, as the JAX package's single-device path takes
               it, or with PHI_TPU_DEVICE_READ_SKETCH=1 the seq kernel on
               `device`; reports bases/s and k-mers/s (every window
               position is a k-mer the scan evaluates);
  * `sketch@Ndev` (`--mesh N`) — the same over a mesh of N devices of
               `device`'s type (N visible cards for cuda, N CPU shards for
               cpu): the reads split over the N devices, each shard on
               the seq kernel (the dp axis of parallel/sharded.py);
  * `join`   — the fused sketch+join of one long sequence against a
               spectrum (hot loop #3): `sketch.kernels.join_many` on
               `device`, the rows kernel on a card; the spectrum is
               sampled from the sequence's first 4 Mbp by
               `sketch_sequence` (the seq kernel).

Each metric reports the median of `repeats` warm runs with IQR and the
raw observations (one untimed run first), plus, on a card, the
memory-rate ceiling for the sketch's 2-bit packed input and the achieved
fraction. Output: one JSON line per metric.

    python -m phi_tpu_torch.eval.throughput --mbases 64 [--device cuda] \
        [--mesh N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from phi_tpu_torch.eval.stats import summarize

# H100 SXM device memory rate (NVIDIA data sheet). The sketch streams
# 2-bit packed bases (0.25 B/base read); the memory ceiling is the hard
# upper bound reported for context.
H100_HBM_BYTES_PER_S = 3.35e12
SKETCH_BYTES_PER_BASE = 0.25  # 2-bit packed input; outputs are ~1e-3 of it


def _roofline(backend: str, bases_per_s: float) -> dict:
    if backend != "cuda":
        return {}
    ceiling = H100_HBM_BYTES_PER_S / SKETCH_BYTES_PER_BASE
    return {"hbm_roofline_bases_per_s": round(ceiling),
            "hbm_roofline_fraction": round(bases_per_s / ceiling, 6)}


def _rand_reads(rng: np.random.Generator, total_bases: int,
                read_len: int = 150) -> tuple[np.ndarray, np.ndarray]:
    n_reads = max(1, total_bases // read_len)
    concat = rng.integers(0, 4, n_reads * read_len, dtype=np.uint8)
    off = np.arange(n_reads + 1, dtype=np.int64) * read_len
    return concat, off


def bench_sketch(total_bases: int, k: int = 31, w: int = 25,
                 repeats: int = 5, devices=None, device="cuda") -> dict:
    """Read-spectrum sketch throughput (the sketch_read_concat path, with
    `devices` a mesh's devices)."""
    from phi_tpu_torch.sketch.minimizer import sketch_read_concat
    rng = np.random.default_rng(0)
    concat, off = _rand_reads(rng, total_bases)

    def run():
        return sketch_read_concat(concat, off, k, w, devices=devices,
                                  device=device)
    hi, lo = run()  # warm-up
    times = []
    for _ in range(repeats):
        t0 = time.time()
        hi, lo = run()
        times.append(time.time() - t0)
    st = summarize(times)
    n_windows = len(concat) - (len(off) - 1) * (k + w - 2)  # evaluated k-mers
    return {"data": "synthetic", "metric": "sketch" if devices is None
            else f"sketch@{len(devices)}dev",
            "bases_per_s": round(len(concat) / st["median_s"]),
            "kmers_per_s": round(max(n_windows, 0) / st["median_s"]),
            "spectrum": int(len(hi)), **st}


def bench_join(total_bases: int, k: int = 31, w: int = 25,
               repeats: int = 5, device="cuda") -> dict:
    """Fused haplotype sketch+join throughput (one long sequence vs a
    spectrum sampled from itself — every window does the table probe),
    on `device`; each timed run ends with its hits on the host."""
    from phi_tpu_torch.pipeline import resolve_device
    from phi_tpu_torch.sketch.kernels import join_many, sketch_sequence
    device = resolve_device(device)
    rng = np.random.default_rng(1)
    seq = rng.integers(0, 4, total_bases, dtype=np.uint8)
    hi, lo, _pos = sketch_sequence(seq[: min(total_bases, 1 << 22)], k, w,
                                   device=device)
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    key = np.unique(key)
    sp_hi = (key >> np.uint64(32)).astype(np.uint32)
    sp_lo = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    join_many([seq], k, w, sp_hi, sp_lo, device=device)  # warm-up
    times, n_hits = [], 0
    for _ in range(repeats):
        t0 = time.time()
        out = join_many([seq], k, w, sp_hi, sp_lo, device=device)
        times.append(time.time() - t0)
        n_hits = int(len(out[0][1]))
    st = summarize(times)
    return {"data": "synthetic", "metric": "join",
            "bases_per_s": round(total_bases / st["median_s"]),
            "kmers_per_s": round((total_bases - k - w + 2) / st["median_s"]),
            "hits": n_hits, **st}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="phi-torch-throughput")
    ap.add_argument("--mbases", type=float, default=64.0,
                    help="input size in megabases (default 64)")
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--w", type=int, default=25)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--mesh", type=int, default=0,
                    help="also run the dp-sharded sketch over N devices")
    ap.add_argument("--out", default=None, help="write JSONL artifact here")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="torch device of the join and the device "
                         "sketch [cuda]")
    args = ap.parse_args(argv)
    try:
        import torch

        from phi_tpu_torch.pipeline import mesh_for, resolve_device
        device = resolve_device(args.device)
        mesh = mesh_for(args.mesh, device) if args.mesh > 1 else None
        total = int(args.mbases * 1e6)
        rows = [bench_sketch(total, args.k, args.w, args.repeats,
                             device=device),
                bench_join(total, args.k, args.w, args.repeats, device)]
        if mesh is not None:
            rows.append(bench_sketch(total, args.k, args.w, args.repeats,
                                     devices=mesh.flat))
    except (ValueError, OSError, RuntimeError) as e:
        sys.stderr.write(f"[E::main] {e}\n")
        return 1
    backend = device.type
    name = (torch.cuda.get_device_name(device) if backend == "cuda"
            else "cpu")
    lines = []
    for r in rows:
        r["backend"] = backend
        r["device"] = name
        r.update(_roofline(backend, r["bases_per_s"]))
        line = json.dumps(r)
        lines.append(line)
        print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
