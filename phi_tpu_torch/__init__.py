"""PHI on PyTorch and CUDA: the port of `phi_tpu` to one NVIDIA H100.

The package mirrors `phi_tpu`'s layout and imports nothing of it: the host
modules it needs (`config`, `logging`, `emit`, `checkpoint`, `native`,
`graph.pangenome`, `io.*`, `eval.*`) are its own copies. Device stages are
torch ops on an explicit `torch.device`; the five TPU kernels (the rows3,
rows3w, rows2 and rows sketches and the single-sequence sketch) are
hand-written CUDA in `csrc/rows.cu`, each with a plain torch twin that runs
on CPU tensors. Nothing here imports jax.
"""

__version__ = "0.1.0"


def _tune_malloc() -> None:
    """Keep large allocations on the reusable heap instead of per-block
    mmaps (the JAX package's `phi_tpu._tune_malloc`, which its host phases
    were measured with). The hot host phases churn through 50-200 MB numpy
    temporaries; glibc serves those via mmap and munmaps them on free, so
    every round re-faults every page, and on virtualized hosts a fault
    storm can cost 10-60x the compute itself. Raising the mmap threshold
    (and disabling trim) makes freed blocks reusable: the fault cost is paid
    once per high-water mark. Best-effort; only meaningful on glibc/Linux."""
    import ctypes
    import sys
    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL(None)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, -1)       # M_TRIM_THRESHOLD
    except Exception:
        pass


_tune_malloc()
