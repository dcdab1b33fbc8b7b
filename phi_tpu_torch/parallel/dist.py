"""Multi-process initialization and read-shard planning: the port of
`phi_tpu/parallel/dist.py`.

Each process loads its shard of the read set (read_shard_bounds) and the
spectra are merged with a sorted all-gather over torch.distributed's gloo
backend, on the host; the sharded DP (parallel/sharded.py) then runs in
each process over its own mesh.
"""

from __future__ import annotations

import atexit

import numpy as np
import torch
import torch.distributed as tdist

_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> tuple[int, int]:
    """Join a gloo process group at tcp://coordinator_address (host:port)
    when num_processes > 1; a no-op for one process. Returns (rank, world
    size). The group is left (shutdown) when the interpreter exits."""
    if num_processes is not None and num_processes > 1 \
            and not tdist.is_initialized():
        tdist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
        atexit.register(shutdown)
    if tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def shutdown() -> None:
    """Leave the process group: a barrier, so that no process closes its
    sockets while another still reads from them, then the group's
    teardown. A process that exits with the group alive (its gloo threads
    and, on rank 0, the store's server still running) can abort in its
    exit."""
    if tdist.is_initialized():
        try:
            tdist.barrier()
        finally:
            tdist.destroy_process_group()


def read_shard_bounds(n_reads: int, process_index: int,
                      process_count: int) -> tuple[int, int]:
    """Contiguous per-host read shard (data-parallel axis)."""
    per = -(-n_reads // process_count)
    lo = min(n_reads, process_index * per)
    return lo, min(n_reads, lo + per)


def _split(key: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return ((key >> np.uint64(32)).astype(np.uint32),
            (key & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _all_gather(x: torch.Tensor) -> list[torch.Tensor]:
    out = [torch.empty_like(x) for _ in range(tdist.get_world_size())]
    tdist.all_gather(out, x)
    return out


def merge_spectra(local_hi: np.ndarray, local_lo: np.ndarray):
    """Union of the processes' spectra as sorted (hi, lo) uint32. With one
    process, the sorted dedup of the local spectrum; otherwise every
    process all-gathers the lengths, pads its keys to the longest with the
    (0xFFFFFFFF, 0xFFFFFFFF) pair, all-gathers them, dedups and drops the
    pad."""
    key = (np.asarray(local_hi, np.uint64) << np.uint64(32)) \
        | np.asarray(local_lo, np.uint64)
    if not tdist.is_initialized() or tdist.get_world_size() == 1:
        return _split(np.unique(key))
    n_max = max(int(n) for n in _all_gather(
        torch.tensor([len(key)], dtype=torch.int64)))
    pad = np.full(n_max, _SENTINEL, np.uint64)
    pad[:len(key)] = key
    parts = _all_gather(torch.from_numpy(pad.view(np.int64)))
    key = np.unique(torch.cat(parts).numpy().view(np.uint64))
    return _split(key[key != _SENTINEL])
