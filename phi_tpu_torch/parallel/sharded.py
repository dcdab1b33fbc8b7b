"""The mesh: the port of `phi_tpu/parallel/sharded.py`, single-controller.

Mesh axes (the meaningful parallelism axes of this problem):
  dp  — data parallel over reads: each shard sketches its read batch and hit
        counts are merged with a psum (the reference's OpenMP read loop,
        ILP_index.cpp:617, scaled across devices).
  hap — lanes (haplotype walks) sharded: the per-vertex entry reduction
        becomes a cross-shard min.
  sp  — walk positions sharded: the prefix-min becomes a blocked scan with
        a carry exchange across shards, and the exact-credit shifts take an
        L-column halo from the left neighbour.

One process drives every shard, as JAX's shard_map does within one
process. A shard's step is a function over its local block, and each
collective is a small helper over the list of shard tensors, moved with
`.to(device)`: `_pmin` over hap and sp, `_psum` over dp, `_all_gather` of
the sp totals, `_left_halo` (the ppermute) and `_pmax` (the convergence
vote). A mesh's devices may repeat, so the whole sharded path runs as four
shards on one card or eight on the CPU. The dp replicas of a hap x sp block
compute the same values under shard_map; here the block runs once, on its
dp = 0 device. torch.distributed carries only the multi-process spectrum
merge (dist.py): NCCL will not put two ranks on one card.

`count_collectives()` counts what the helpers move while it is active
(`CollectiveCount`); the solver marks its scopes (setup, each sweep, each
convergence vote, the end), so one sweep's traffic reads apart from the
one-off terms. With no count active the helpers do nothing more.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from phi_tpu_torch import state
from phi_tpu_torch.parallel.dist import read_shard_bounds
from phi_tpu_torch.trace import span

_INF = float("inf")


class Mesh:
    """A (dp, hap, sp) array of torch devices; a device may repeat."""

    AXES = ("dp", "hap", "sp")

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = dict(zip(self.AXES, devices.shape))

    @property
    def flat(self) -> list[torch.device]:
        """Every device in (dp, hap, sp) order."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        devices = sorted({str(d) for d in self.flat})
        return (f"Mesh({self.shape['dp']}x{self.shape['hap']}x"
                f"{self.shape['sp']} on {devices})")


def factor_mesh(n_devices: int) -> tuple[int, int, int]:
    """(dp, hap, sp) factors for n devices."""
    ns = 2 if n_devices % 2 == 0 else 1
    nh = 2 if n_devices % 4 == 0 else 1
    return n_devices // (ns * nh), nh, ns


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of n_devices. By default over the visible CUDA devices, and a
    ValueError naming both counts when fewer than n_devices are visible;
    an explicit device list (such as [cuda:0] * 4 or [cpu] * 8) is taken as
    given."""
    if devices is None:
        n_vis = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n_vis)]
        if n_devices is None:
            n_devices = n_vis
        if n_devices < 1 or n_vis < n_devices:
            raise ValueError(f"a mesh of {n_devices} devices needs "
                             f"{n_devices} visible CUDA devices; {n_vis} "
                             f"visible")
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"a mesh of {n_devices} devices from a list of "
                         f"{len(devices)}")
    arr = np.empty(n_devices, dtype=object)
    for i, d in enumerate(devices[:n_devices]):
        arr[i] = d
    return Mesh(arr.reshape(factor_mesh(n_devices)))


def _pad_to(x: np.ndarray, axis: int, mult: int, value) -> np.ndarray:
    n = x.shape[axis]
    target = -(-n // mult) * mult
    if target == n:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad, constant_values=value)


def prepare_sharded_tables(tables, mesh: Mesh):
    """Pad the solver tables to mesh-divisible shapes (numpy, host side)."""
    tables = tables.dense()
    nh = mesh.shape["hap"]
    ns = mesh.shape["sp"]
    S = _pad_to(_pad_to(tables.S, 0, nh, 0.0), 1, ns, 0.0)
    B = _pad_to(_pad_to(tables.B, 0, nh, 0.0), 1, ns, 0.0)
    sv = _pad_to(_pad_to(tables.state_vertex, 0, nh, -1), 1, ns, -1)
    wl = _pad_to(tables.walk_len, 0, nh, 0)
    return S, B, sv, wl


# ----------------------------------------------------- collective counts

KINDS = ("all-reduce", "all-gather", "collective-permute")


def _scope_record() -> dict:
    return {"calls": dict.fromkeys(KINDS, 0),
            "out_bytes": dict.fromkeys(KINDS, 0),
            "moved_bytes": dict.fromkeys(KINDS, 0), "host_syncs": 0}


class CollectiveCount:
    """What the collective helpers did while count_collectives was active,
    in scopes in the order the solver marked them: `setup`, one `sweep` per
    executed sweep, one `vote` per convergence vote, `end` (collectives
    before the first mark go to `other`). Per scope and kind, summed over
    the shards that take part in each call:
      calls        each shard's part in a collective (in the JAX package's
                   terms, one HLO instruction executed on one device);
      out_bytes    the bytes of the collective's output on each shard (an
                   HLO instruction's output shape);
      moved_bytes  the bytes of every tensor handed from one shard index to
                   another, even where both lie on one card: the traffic
                   that would cross NVLink with one card per shard. The
                   helpers reduce onto a group's first shard and broadcast
                   from it, so a reduction over G shards moves 2 (G - 1)
                   tensors; the vote reads its result on the host instead
                   of broadcasting it, and moves G - 1 flags.
    and per scope `host_syncs`, the device-to-host reads the solver waits
    on (the vote's bool, end_min's float). A group of one shard runs no
    collective and counts none. wall_s gives the host seconds from each
    mark to the next: a sweep's is the time to queue it, its vote's the
    wait for the device to finish it."""

    def __init__(self):
        self.scopes: list[tuple[str, dict]] = []
        self._starts: list[float] = []
        self._stop = None

    def mark(self, name: str) -> None:
        self.scopes.append((name, _scope_record()))
        self._starts.append(time.perf_counter())

    def close(self) -> None:
        self._stop = time.perf_counter()

    def _current(self) -> dict:
        if not self.scopes:
            self.mark("other")
        return self.scopes[-1][1]

    def add(self, kind: str, shards: int, out_bytes: int,
            moved_bytes: int) -> None:
        if shards > 1:
            rec = self._current()
            rec["calls"][kind] += shards
            rec["out_bytes"][kind] += out_bytes
            rec["moved_bytes"][kind] += moved_bytes

    def sync(self) -> None:
        self._current()["host_syncs"] += 1

    def records(self, name: str) -> list[dict]:
        """The records of every scope marked `name`, in order."""
        return [rec for n, rec in self.scopes if n == name]

    def wall_s(self, name: str) -> float:
        """Host seconds in the scopes marked `name`, each from its mark to
        the next (the last to the count's close)."""
        ends = self._starts[1:] + [self._stop]
        return sum(e - s for (n, _), s, e in zip(self.scopes, self._starts,
                                                  ends) if n == name)


_COUNT: CollectiveCount | None = None  # the active count, if any


@contextlib.contextmanager
def count_collectives():
    """Count the collectives run inside the block; yields the
    CollectiveCount. The previous count, if any, is restored after."""
    global _COUNT
    prev, _COUNT = _COUNT, CollectiveCount()
    try:
        yield _COUNT
    finally:
        _COUNT.close()
        _COUNT = prev


def _mark(name: str) -> None:
    if _COUNT is not None:
        _COUNT.mark(name)


# ------------------------------------------------------------ collectives

def _pmin(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Elementwise min over every shard's tensor, on every shard."""
    acc = xs[0]
    for x in xs[1:]:
        acc = torch.minimum(acc, x.to(acc.device))
    if _COUNT is not None:
        n, b = len(xs), acc.nbytes
        _COUNT.add("all-reduce", n, n * b, 2 * (n - 1) * b)
    return [acc.to(x.device) for x in xs]


def _psum(xs: list[torch.Tensor]) -> torch.Tensor:
    """Elementwise sum over the shards' tensors, on the first's device."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x.to(acc.device)
    if _COUNT is not None:
        n, b = len(xs), acc.nbytes
        _COUNT.add("all-reduce", n, n * b, (n - 1) * b)
    return acc


def _pmax(flags: list[torch.Tensor]) -> bool:
    """Whether any shard's flag is set (the convergence vote)."""
    dev = flags[0].device
    if _COUNT is not None:
        n, b = len(flags), flags[0].nbytes
        _COUNT.add("all-reduce", n, n * b, (n - 1) * b)
        _COUNT.sync()
    return bool(torch.stack([f.to(dev) for f in flags]).any())


def _all_gather(xs: list[torch.Tensor], dim: int = 0,
                tiled: bool = False) -> list[torch.Tensor]:
    """Every shard's tensor of one sp row on each of them: stacked along a
    new dim, or concatenated along dim when tiled."""
    out = []
    for x in xs:
        parts = [y.to(x.device) for y in xs]
        out.append(torch.cat(parts, dim) if tiled
                   else torch.stack(parts, dim))
    if _COUNT is not None:
        n, b = len(xs), sum(x.nbytes for x in xs)
        _COUNT.add("all-gather", n, n * b, (n - 1) * b)
    return out


def _left_halo(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The ppermute of one sp row: shard j receives shard j - 1's tensor
    (INF for the first shard)."""
    if _COUNT is not None:
        n, b = len(xs), xs[0].nbytes
        _COUNT.add("collective-permute", n, n * b, (n - 1) * b)
    return [torch.full_like(xs[0], _INF)] + [
        xs[j - 1].to(xs[j].device) for j in range(1, len(xs))]


# ------------------------------------------------------- the local blocks

@dataclasses.dataclass
class _Block:
    """One (hap, sp) block of the solve: its device, its global offsets and
    the weight-independent tables it owns."""
    device: torch.device
    hi: int                  # hap block index
    si: int                  # sp block index
    gcol: torch.Tensor       # int64 [Ps] global columns
    valid: torch.Tensor      # bool [Hs, Ps]
    vtx_clip: torch.Tensor   # int64 [Hs, Ps]
    has_vtx: torch.Tensor    # bool [Hs, Ps]
    is_end: torch.Tensor     # bool [Hs, Ps]: the lane's last position
    src_h: torch.Tensor      # int64: local lane of each owned esrc row
    src_p: torch.Tensor      # int64: local position of each owned esrc row
    src_t: torch.Tensor      # int64: its target vertex


def _blocks(mesh: Mesh, state_vertex, walk_len, esrc_h, esrc_p, esrc_target
            ) -> tuple[list[_Block], int, int]:
    """The solve's blocks, in (hap, sp) row-major order, from the padded
    state_vertex [Hp, Pp] and walk_len [Hp] and the esrc tables (numpy or
    tensors); returns (blocks, Hs, Ps)."""
    sv = np.asarray(torch.as_tensor(state_vertex).cpu())
    wl = np.asarray(torch.as_tensor(walk_len).cpu()).astype(np.int64)
    eh, ep, et = (np.asarray(torch.as_tensor(a).cpu()).astype(np.int64)
                  for a in (esrc_h, esrc_p, esrc_target))
    grid = mesh.devices[0]  # the hap x sp devices (the dp = 0 plane)
    nh, ns = grid.shape
    Hp, Pp = sv.shape
    if Hp % nh or Pp % ns:
        raise ValueError(f"tables [{Hp}, {Pp}] do not divide over a "
                         f"{nh} x {ns} hap x sp grid "
                         "(prepare_sharded_tables pads them)")
    Hs, Ps = Hp // nh, Pp // ns
    blocks = []
    for hi in range(nh):
        for si in range(ns):
            dev = grid[hi, si]
            h0, p0 = hi * Hs, si * Ps
            gcol = np.arange(p0, p0 + Ps)
            wlb = wl[h0:h0 + Hs]
            svb = sv[h0:h0 + Hs, p0:p0 + Ps].astype(np.int64)
            valid = gcol[None, :] < wlb[:, None]
            mine = (eh >= h0) & (eh < h0 + Hs) & (ep >= p0) & (ep < p0 + Ps)

            def t(a, dev=dev):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            blocks.append(_Block(
                dev, hi, si, t(gcol), t(valid), t(np.maximum(svb, 0)),
                t(svb >= 0), t(valid & (gcol[None, :] == wlb[:, None] - 1)),
                t(eh[mine] - h0), t(ep[mine] - p0), t(et[mine])))
    return blocks, Hs, Ps


def _split(x, blocks: list[_Block], Hs: int, Ps: int, dtype=torch.float32
           ) -> list[torch.Tensor]:
    """Each block's [..., Hs, Ps] slice of a padded global plane (numpy or
    tensor), on its device."""
    x = torch.as_tensor(x)
    return [x[..., b.hi * Hs:(b.hi + 1) * Hs, b.si * Ps:(b.si + 1) * Ps]
            .to(device=b.device, dtype=dtype).contiguous() for b in blocks]


def _gather(xs: list[torch.Tensor], blocks: list[_Block]) -> torch.Tensor:
    """The global plane of the blocks' [Hs, Ps] tensors, on the first
    block's device."""
    dev = blocks[0].device
    ns = max(b.si for b in blocks) + 1
    rows = [torch.cat([x.to(dev) for x in xs[i:i + ns]], 1)
            for i in range(0, len(xs), ns)]
    return torch.cat(rows, 0)


def _rows(xs: list, ns: int) -> list[list]:
    """The blocks' items grouped by sp row."""
    return [xs[i:i + ns] for i in range(0, len(xs), ns)]


# ---------------------------------------------------------- the sweep

def _sparse_entry_min(blocks: list[_Block], D: list[torch.Tensor],
                      n_vtx: int) -> list[torch.Tensor]:
    """Per-vertex entry minima over the switch sources, without
    replicating the [H, P] exit plane: each block takes the minimum over
    the esrc rows whose (lane, position) it owns, and the [n_vtx] partial
    minima are merged with a pmin over hap and sp."""
    parts = []
    for b, d in zip(blocks, D):
        ent = torch.full((n_vtx,), _INF, dtype=d.dtype, device=b.device)
        parts.append(ent.scatter_reduce_(0, b.src_t, d[b.src_h, b.src_p],
                                         "amin"))
    return _pmin(parts)


def _exit(b: _Block, M: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.where(b.valid, M - B, _INF)


def _entry(b: _Block, ent: torch.Tensor, S: torch.Tensor, R: float
           ) -> torch.Tensor:
    """A = E + S on valid lanes: E the entry charge R + Ent[vertex], and 0
    at a lane's start."""
    E = torch.where(b.has_vtx, ent[b.vtx_clip] + R, _INF)
    if b.si == 0:
        E[:, 0] = E[:, 0].clamp(max=0.0)
    return torch.where(b.valid, E + S, _INF)


def _carried_scan(blocks: list[_Block], A: list[torch.Tensor], ns: int
                  ) -> list[torch.Tensor]:
    """The blocked prefix-min along sp: each block's cummin, lowered by the
    minimum of its predecessors' totals (all_gather of the totals)."""
    local = [torch.cummin(a, 1).values for a in A]
    scans = []
    for row_b, row_l in zip(_rows(blocks, ns), _rows(local, ns)):
        gathered = _all_gather([x[:, -1] for x in row_l])
        for b, x, all_tot in zip(row_b, row_l, gathered):
            pred = torch.arange(ns, device=b.device)[:, None] < b.si
            carry = torch.where(pred, all_tot, _INF).min(0).values
            scans.append(torch.minimum(x, carry[:, None]))
    return scans


def _straddle(blocks: list[_Block], A: list[torch.Tensor],
              W: list[torch.Tensor], L: int, ns: int, Ps: int
              ) -> list[torch.Tensor]:
    """The exact-credit sweep's M' from A: the prefix-min shifted by L
    columns, and the L recent entries less their open straddlers W[j]."""
    if L > Ps:
        # shards narrower than L columns: a full-row gather along sp
        out = []
        for row_b, row_a, row_w in zip(_rows(blocks, ns), _rows(A, ns),
                                       _rows(W, ns)):
            for b, A_sp, Wb in zip(row_b, _all_gather(row_a, 1, True),
                                   row_w):
                scan_full = torch.cummin(A_sp, 1).values
                Mn = torch.where((b.gcol >= L)[None, :],
                                 scan_full[:, (b.gcol - L).clamp(min=0)],
                                 _INF)
                for j in range(L):
                    aj = torch.where((b.gcol >= j)[None, :],
                                     A_sp[:, (b.gcol - j).clamp(min=0)], _INF)
                    Mn = torch.minimum(Mn, aj - Wb[j])
                out.append(Mn)
        return out
    # the blocked prefix-min with carry exchange and L-column left halos
    scan = _carried_scan(blocks, A, ns)
    out = []
    for row_b, row_s, row_a, row_w in zip(_rows(blocks, ns), _rows(scan, ns),
                                          _rows(A, ns), _rows(W, ns)):
        halo_scan = _left_halo([s[:, Ps - L:] for s in row_s])
        halo_A = _left_halo([a[:, Ps - L:] for a in row_a])
        for b, s, a, Wb, hs, ha in zip(row_b, row_s, row_a, row_w,
                                       halo_scan, halo_A):
            scanpad = torch.cat([hs, s], 1)
            Mn = torch.where((b.gcol >= L)[None, :], scanpad[:, :Ps], _INF)
            Apad = torch.cat([ha, a], 1)
            for j in range(L):
                aj = torch.where((b.gcol >= j)[None, :],
                                 Apad[:, L - j:L - j + Ps], _INF)
                Mn = torch.minimum(Mn, aj - Wb[j])
            out.append(Mn)
    return out


class _Solver:
    """The sweep over one mesh's blocks, with the R, n_vtx and layer count
    of a solve."""

    def __init__(self, mesh: Mesh, R: float, n_vtx: int, n_layers: int):
        self.mesh = mesh
        self.R = float(np.float32(R))
        self.n_vtx = n_vtx
        self.L = n_layers
        self.ns = mesh.shape["sp"]

    def setup(self, state_vertex, walk_len, esrc_h, esrc_p, esrc_target):
        _mark("setup")
        self.blocks, self.Hs, self.Ps = _blocks(
            self.mesh, state_vertex, walk_len, esrc_h, esrc_p, esrc_target)

    def split(self, x) -> list[torch.Tensor]:
        return _split(x, self.blocks, self.Hs, self.Ps)

    def sweep(self, M, S, B, W) -> list[torch.Tensor]:
        blocks = self.blocks
        D = [_exit(b, m, bb) for b, m, bb in zip(blocks, M, B)]
        ent = _sparse_entry_min(blocks, D, self.n_vtx)
        A = [_entry(b, e, s, self.R) for b, e, s in zip(blocks, ent, S)]
        if self.L == 0:
            return _carried_scan(blocks, A, self.ns)
        return _straddle(blocks, A, W, self.L, self.ns, self.Ps)

    def fixpoint(self, S, B, W, max_sweeps: int):
        """The sweeps to convergence (at least 2; then while any entry drops
        by more than 1e-4, capped at max_sweeps): (M blocks, sweeps)."""
        M0 = [torch.full((self.Hs, self.Ps), _INF, device=b.device)
              for b in self.blocks]
        _mark("sweep")
        M1 = self.sweep(M0, S, B, W)
        _mark("sweep")
        M = self.sweep(M1, S, B, W)
        it = 2
        while it < max_sweeps:
            _mark("vote")
            if not _pmax([(m < p - 1e-4).any() for m, p in zip(M, M1)]):
                break
            _mark("sweep")
            M1, M = M, self.sweep(M, S, B, W)
            it += 1
        return M, it

    def end_min(self, M, B) -> float:
        _mark("end")
        ends = [torch.where(b.is_end, _exit(b, m, bb), _INF).min()
                for b, m, bb in zip(self.blocks, M, B)]
        end = _pmin(ends)[0]
        if _COUNT is not None:
            _COUNT.sync()
        return float(end)


def sharded_solve(mesh: Mesh, *, R: float, n_vtx: int, max_sweeps: int = 256):
    """Convergence-based sharded DP solver (lanes over hap, positions over
    sp, the blocked prefix-min with carry exchange, the fixpoint with a
    cross-shard convergence vote). Returns a function
    (S, B, state_vertex, walk_len, esrc_h, esrc_p, esrc_target), the planes
    padded by prepare_sharded_tables, -> (M f32 [Hp, Pp] on the first
    shard's device, end_min, sweeps)."""

    def run(S, B, state_vertex, walk_len, esrc_h, esrc_p, esrc_target):
        sol = _Solver(mesh, R, n_vtx, 0)
        sol.setup(state_vertex, walk_len, esrc_h, esrc_p, esrc_target)
        Sb, Bb = sol.split(S), sol.split(B)
        M, sweeps = sol.fixpoint(Sb, Bb, None, max_sweeps)
        end = sol.end_min(M, Bb)
        return _gather(M, sol.blocks), end, sweeps

    return run


def sharded_solve_exact(mesh: Mesh, *, R: float, n_vtx: int, n_layers: int,
                        max_sweeps: int = 256):
    """Exact-credit sharded DP (solve.dp.solve_exact over the mesh): the W
    straddle layers are sharded like S and B; each sweep exchanges the sp
    totals and two [Hs, L] left halos, or, where a shard is narrower than
    L columns, gathers the full row of A along sp. Returns a function
    (S, B, W, state_vertex, walk_len, esrc_h, esrc_p, esrc_target) ->
    (M, end_min, sweeps), as sharded_solve's."""

    def run(S, B, W, state_vertex, walk_len, esrc_h, esrc_p, esrc_target):
        sol = _Solver(mesh, R, n_vtx, n_layers)
        sol.setup(state_vertex, walk_len, esrc_h, esrc_p, esrc_target)
        Sb, Bb, Wb = sol.split(S), sol.split(B), sol.split(W)
        M, sweeps = sol.fixpoint(Sb, Bb, Wb, max_sweeps)
        end = sol.end_min(M, Bb)
        return _gather(M, sol.blocks), end, sweeps

    return run


def _read_hits(codes: np.ndarray, lengths: np.ndarray, sp_key: torch.Tensor,
               k: int, w: int, device) -> torch.Tensor:
    """One dp shard's hit count per spectrum key (int32 [n_sp]): its reads
    (rows of a padded batch) as rows of one seq kernel launch, the emitted
    windows' keys looked up in the sorted spectrum."""
    from phi_tpu_torch.ops.search import pair_isin
    from phi_tpu_torch.sketch.kernels import BLK, sketch_seq
    n = sp_key.shape[0]
    halo = k + w - 2
    width = codes.shape[1]
    need = (max(1, -(-(width - halo) // BLK)) + 1) * BLK
    buf = np.full((len(codes), need), 4, np.uint8)
    buf[:, :width] = codes
    nvalid = np.maximum(np.asarray(lengths, np.int64) - halo, 0)
    key, _, emit = sketch_seq(torch.from_numpy(buf).to(device),
                              torch.from_numpy(nvalid.astype(np.int32))
                              .to(device), k, w)
    found, idx = pair_isin(sp_key.to(device), key[emit])
    return torch.bincount(idx[found], minlength=n).to(torch.int32)


def sharded_full_step(mesh: Mesh, *, k: int, w: int, R: float, n_vtx: int,
                      n_sweeps: int = 4):
    """The multi-device step:
      (read_codes, read_lengths, spectrum_keys_hi/lo, S, B, state_vertex,
       walk_len, esrc tables) -> (hit_counts, M, dp_end_min)

    One call = the read sketch and spectrum hit count on the dp axis (the
    batch's rows split over dp, each shard's rows through the seq kernel
    on its device, the counts summed with a psum) + n_sweeps DP relaxation
    sweeps over hap x sp. hit_counts (int32 [n_sp]) and M (f32 [Hp, Pp])
    are on the first shard's device."""

    def run(codes, lengths, sp_hi, sp_lo, S, B, state_vertex, walk_len,
            esrc_h, esrc_p, esrc_target):
        codes = np.asarray(codes, np.uint8)
        lengths = np.asarray(lengths)
        nd = mesh.shape["dp"]
        sp_key = state.spectrum_keys(sp_hi, sp_lo, "cpu")
        parts = []
        for i in range(nd):
            lo, hi = read_shard_bounds(len(codes), i, nd)
            dev = mesh.devices[i, 0, 0]
            if lo >= hi:
                parts.append(torch.zeros(len(sp_key), dtype=torch.int32,
                                         device=dev))
                continue
            parts.append(_read_hits(codes[lo:hi], lengths[lo:hi], sp_key,
                                    k, w, dev))
        hits = _psum(parts)

        sol = _Solver(mesh, R, n_vtx, 0)
        sol.setup(state_vertex, walk_len, esrc_h, esrc_p, esrc_target)
        Sb, Bb = sol.split(S), sol.split(B)
        M = [torch.full((sol.Hs, sol.Ps), _INF, device=b.device)
             for b in sol.blocks]
        for _ in range(n_sweeps):
            M = sol.sweep(M, Sb, Bb, None)
        return hits, _gather(M, sol.blocks), sol.end_min(M, Bb)

    return run


def _pad_planes(x: torch.Tensor, Hp: int, Pp: int) -> torch.Tensor:
    """x [..., H, P] zero-padded to [..., Hp, Pp]."""
    H, P = x.shape[-2:]
    return torch.nn.functional.pad(x, (0, Pp - P, 0, Hp - H))


def _padded_statics(tables, mesh: Mesh):
    """The padded plane shape (Hp, Pp) and the sharded solvers' last five
    arguments: state_vertex and walk_len padded to the mesh, and the esrc
    tables."""
    H, P = tables.state_vertex.shape
    nh, ns = mesh.shape["hap"], mesh.shape["sp"]
    sv = _pad_to(_pad_to(tables.state_vertex, 0, nh, -1), 1, ns, -1)
    wl = _pad_to(tables.walk_len, 0, nh, 0)
    return ((-(-H // nh) * nh, -(-P // ns) * ns),
            (sv, wl, tables.esrc_h, tables.esrc_p, tables.esrc_target))


def exact_solver_args(tables, mesh: Mesh):
    """sharded_solve_exact's arguments for exact-mode tables, as
    solve_dp_sharded gives them: S, B and W built by solve.dp.build_sbw on
    the first shard's device from the device occurrence columns (or the
    host ones) and zero-padded to the mesh, then _padded_statics'. Returns
    (arguments, B unpadded)."""
    from phi_tpu_torch.solve.dp import build_sbw
    dev0 = mesh.flat[0]
    H, P = tables.state_vertex.shape
    d = tables.occ_dev
    if d is not None:
        oh, os_, osp, ow = d.dev_hap, d.dev_s, d.dev_span, d.dev_w
        if tables.occ_weight is not None:
            ow = state.occ_weights(tables.occ_weight, dev0)
    else:
        oh, os_, osp, ow = state.occ_tensors(
            tables.occ_hap, tables.occ_start,
            tables.occ_end - tables.occ_start, tables.occ_weight, dev0)
    S, B, W = build_sbw(oh, os_, osp, ow, H, P, tables.n_layers)
    (Hp, Pp), statics = _padded_statics(tables, mesh)
    return tuple(_pad_planes(x, Hp, Pp) for x in (S, B, W)) + statics, B


def solve_dp_sharded(tables, mesh: Mesh, max_sweeps: int = 256):
    """Drop-in sharded counterpart of solve.dp.solve_dp: the same
    (solution, ends, n_sweeps, dp_objective), computed over the mesh (lanes
    on hap, positions on sp). Exact mode builds S, B and W with
    solve.dp.build_sbw on the first shard's device and splits them into
    blocks (exact_solver_args); bracket mode (n_layers None) runs the
    search fixpoint, and the optimistic one (S := B) for the bound. The
    solution (M, ent, sv_at) is on the first shard's device, as
    decode_path takes it."""
    from phi_tpu_torch.solve.dp import (DeviceSolution, _ends, _sync,
                                        _warn_cap, esrc_ent)
    dev0 = mesh.flat[0]
    H, P = tables.state_vertex.shape
    with span("tables"):
        eh, ep, et, sv0, wl0 = state.solver_static(tables, dev0)
        if tables.n_layers is not None:
            args, B = exact_solver_args(tables, mesh)
            _sync(dev0)
        else:
            (Hp, Pp), statics = _padded_statics(tables, mesh)
            t = tables.dense()
            S, B = state.credit_tensors(t, dev0)
    with span("exec"):
        if tables.n_layers is not None:
            solver = sharded_solve_exact(mesh, R=tables.R,
                                         n_vtx=tables.n_vtx,
                                         n_layers=tables.n_layers,
                                         max_sweeps=max_sweeps)
            M, lb_term, sweeps = solver(*args)
            del args
        else:
            solver = sharded_solve(mesh, R=tables.R, n_vtx=tables.n_vtx,
                                   max_sweeps=max_sweeps)
            Bp = _pad_planes(B, Hp, Pp)
            M, _, sweeps = solver(_pad_planes(S, Hp, Pp), Bp, *statics)
            # the valid lower bound: the optimistic entry charge S := B
            _, lb_term, _ = solver(Bp, Bp, *statics)
        _sync(dev0)
    with span("fetch"):
        M = M[:H, :P].contiguous()
        ent = esrc_ent(M, B, eh, ep, et, wl0, tables.n_vtx).cpu().numpy()
        ends = _ends(M, B, wl0).cpu().numpy()
    _warn_cap(sweeps, max_sweeps)
    lb = float(tables.const + lb_term) if H else float(tables.const)
    return DeviceSolution(M, B, eh, ep, wl0, ent), ends, sweeps, lb
