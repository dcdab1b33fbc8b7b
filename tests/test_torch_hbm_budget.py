"""The port's memory model (eval.hbm_budget) against what the port
allocates, on the CPU at a small size:

- each anchor-stage row equals the nbytes of the tensors the device anchors
  allocate for it (the hit buffers, the spectrum's cuckoo table, walk_mat
  and the prefix hashes, the filter's accumulators, the retained columns),
  and the filter chunk's temporaries equal the peak of new tensors alive in
  one chunk's first pass;
- above MAX_HAPS walks, each row of the hit path's anchor stage equals the
  nbytes of what join_many holds on the device (the mixed table, a batch's
  inputs and hit columns) and the peak of new tensors alive in one batch's
  join_rows;
- each solve row equals the nbytes of S, B, W and the solver statics, and
  the sweep's working set plus W's layer step (or the streamed scratch)
  equals the peak of new tensors alive in solve_exact beside M;
- where the JAX package's model has the same term (S/B/M, the W stack, the
  mesh tile), the two agree;
- the graph's memo rows: the solver statics at any size, walk_mat and its
  hashes only at most WALK_HASHES_MAX_BYTES, and none of them on the hit
  path's solve;
- solve.dp.stream_w flips where the model's materialized solve passes the
  free device memory (the card's memory queries stubbed), and the
  PHI_TPU_STREAM_W_GB cap where the stack passes it.
Peaks are counted by a dispatch mode that tracks each new storage from
the op that creates it until its tensor is freed."""

import types
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

pytest.importorskip("jax")

from phi_tpu.eval import hbm_budget as jbudget  # noqa: E402
from phi_tpu_torch import state  # noqa: E402
from phi_tpu_torch.anchors import device as dv  # noqa: E402
from phi_tpu_torch.eval import hbm_budget as hb  # noqa: E402
from phi_tpu_torch.graph import pangenome  # noqa: E402
from phi_tpu_torch.solve import dp as tdp  # noqa: E402
from tests.test_torch_anchors import _instance, _spectrum  # noqa: E402
from tests.test_torch_stream import _tables  # noqa: E402


class LiveBytes(TorchDispatchMode):
    """Bytes of the storages created inside the block and still held, and
    their peak. A storage is new when no input of its op shares it."""

    def __init__(self):
        super().__init__()
        self.live, self.peak, self.ptrs = 0, 0, set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ins = {t.untyped_storage().data_ptr()
               for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)}
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            p, n = st.data_ptr(), st.nbytes()
            if n == 0 or p in ins or p in self.ptrs:
                continue
            self.ptrs.add(p)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, p, n)
        return out

    def _free(self, p, n):
        self.ptrs.discard(p)
        self.live -= n


def _spy(monkeypatch, module, name, seen):
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.setdefault(name, []).append((args, out))
        return out

    monkeypatch.setattr(module, name, wrapped)


def _nbytes(*ts) -> int:
    return sum(t.untyped_storage().nbytes() for t in ts)


def test_anchor_rows_equal_the_port_tensors(tmp_path, monkeypatch):
    k, w, sb, rows = 21, 11, 2, 2
    (_, graph), reads = _instance(tmp_path)
    spectrum = _spectrum(reads, k, w)
    seen = {}
    graph.release()  # a cold run: walk_mat and its hashes are built
    for module, name in ((dv, "_finalize"), (dv, "build_ph"),
                         (dv, "_kmer_stats"), (state, "cuckoo_tensors")):
        _spy(monkeypatch, module, name, seen)
    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    _, occ = dv.join_anchors_device(graph, seqs, k, w, spectrum[0],
                                    spectrum[1], 1.0, device="cpu",
                                    rows_per_call=rows, super_blocks=sb)
    (se, kid, hap, walk_mat, _, Ksp, H), _ = seen["_finalize"][0]
    H, P = graph.walk_mat.shape
    n_sp = len(spectrum[0])
    windows = hb.walk_windows((c[-1] for c in graph.walk_node_cumlen), k, w)
    model = hb.budget(H, P, 4, n_sp, occ.n_occ, occ.n_hits, windows=windows,
                      w=w, capacity=1 << 40)["per_device_bytes"]["anchors"]
    cap = dv.hit_buffer_len(windows, w, sb, rows)
    assert _nbytes(se, kid, hap) == 3 * 8 * cap
    assert model["hit buffers (3x int64 x CAP)"] == \
        3 * 8 * dv.hit_buffer_len(windows, w)
    (_, tkey_tid) = seen["cuckoo_tensors"][0]
    assert _nbytes(*tkey_tid[:2]) == hb.spectrum_table_bytes(n_sp) == \
        model["spectrum probe table (int64)"]
    phs = [out for _, out in seen["build_ph"]]
    assert len(phs) == 2 and _nbytes(walk_mat, *phs) == model[
        "walk_mat and prefix hashes (int64 [H,P], 2x [H,P+1])"]
    acc = seen["_kmer_stats"][0][0][3]
    assert Ksp == n_sp and _nbytes(*acc) == \
        model["filter accumulators (5x int64 [spectrum])"]
    assert _nbytes(occ.dev_s, occ.dev_span, occ.dev_id, occ.dev_hap,
                   occ.dev_w) == \
        model["occurrence columns (int64 s/span/id/hap, f32 weight)"]

    # one chunk's first pass, at the default chunk (one chunk) and at 512
    ph = [p.reshape(-1) for p in phs]
    pw = [torch.from_numpy(p) for p in dv.pw_tables()]
    for ch in (occ.n_hits, 512):
        acc = tuple(torch.zeros(Ksp, dtype=torch.int64) for _ in range(5))
        c = slice(0, ch)
        with LiveBytes() as lb:
            dv._kmer_stats(kid[c], *dv._group_hashes(
                se[c], kid[c], hap[c], ph, pw, P + 1)[2:], acc)
        assert lb.peak == hb.FIN_COLUMNS * 8 * ch
        row = hb.budget(H, P, 4, n_sp, occ.n_occ, occ.n_hits,
                        windows=windows, w=w, chunk=ch, capacity=1 << 40)
        assert row["per_device_bytes"]["anchors"][
            "filter chunk temporaries (int64 [chunk] columns)"] == lb.peak


@pytest.mark.parametrize("L", [1, 16])
def test_solve_rows_equal_the_port_tensors(L):
    t = _tables(L, seed=7, unit=True)
    H, P, V = t["H"], t["P"], t["V"]
    n = len(t["ow"])

    def i64(a):
        return torch.from_numpy(np.asarray(a, np.int64))
    occ = (i64(t["oh"]), i64(t["os"]), i64(t["span"]),
           torch.from_numpy(t["ow"]))
    tables = types.SimpleNamespace(esrc_h=t["eh"], esrc_p=t["ep"],
                                   esrc_target=t["et"], state_vertex=t["sv"],
                                   walk_len=t["wl"])
    static = state.solver_static(tables, "cpu")
    S, B, W = tdp.build_sbw(*occ, H, P, L)
    for streamed in (False, True):
        both = hb.budget(H, P, L, 1000, n, 10 ** 5, windows=10 ** 6,
                         n_vtx=V, n_esrc=len(t["eh"]), stream_w=streamed,
                         capacity=1 << 40)["per_device_bytes"]
        rows = both["solve"]
        assert rows["S/B/M lane tables (3x f32 [H,P])"] == 3 * S.nbytes
        assert _nbytes(*static) == rows[
            "switch sources and state tables (int64 esrc h/p/target, "
            "state_vertex, walk_len)"]
        # the graph's memo keeps them into the next run's anchors stage
        assert _nbytes(*static) == both["anchors"][
            "held by the graph: switch sources and lane tables"]
        sweep = rows["sweep working set (masks, vertex clip, D, e_state, A, "
                     "scan, Mn, Apad)"]
        Wx = tdp.StreamedW(*occ, H, P, L) if streamed else W
        with LiveBytes() as lb:
            M, _, _ = tdp.solve_exact(S, B, Wx, *static, R=3.0, n_vtx=V,
                                      max_sweeps=256)
        if streamed:
            w_row = rows["W streamed scratch (a layer's f32 scatter target, "
                         "20 B per occurrence)"]
            assert lb.peak == M.nbytes + sweep + w_row
        else:
            w_row = rows["W straddle stack (f32 [L,H,P]) and a layer step"]
            assert W.nbytes == 4 * L * H * P
            assert lb.peak == M.nbytes + sweep + w_row - W.nbytes
        assert hb.solve_bytes(H, P, L, n, streamed, V) == \
            3 * S.nbytes + sweep + w_row


@pytest.mark.parametrize("sp,hap", [(1, 1), (2, 1), (8, 2)])
def test_shared_terms_follow_the_jax_model(sp, hap):
    H, P, L, spec, n_occ = 49, 1_560_000, 16, 4_000_000, 25_000_000
    want = jbudget.budget(H, P, L, spec, n_occ, sp_shards=sp,
                          hap_shards=hap, stream_w=False)
    got = hb.budget(H, P, L, spec, n_occ, 10 ** 8, windows=10 ** 9,
                    sp_shards=sp, hap_shards=hap, stream_w=False,
                    capacity=1 << 40)
    jrows, rows = want["per_device_bytes"], got["per_device_bytes"]["solve"]
    Pd, Hd = want["dims"]["P_per_device"], want["dims"]["H_per_device"]
    assert (got["dims"]["P_per_device"], got["dims"]["H_per_device"]) == \
        (Pd, Hd)
    assert got["mesh"] == want["mesh"] == f"sp={sp} x hap={hap}"
    assert rows["S/B/M lane tables (3x f32 [H,P])"] == \
        jrows["S/B/M lane tables (3x [H,P] f32)"]
    assert rows["W straddle stack (f32 [L,H,P]) and a layer step"] - \
        hb.LAYER_STEP_LANE_BYTES * Hd * Pd == \
        jrows["W straddle stack ([L,H,P] f32)"]


def test_stream_rule_flips_where_the_model_says(monkeypatch):
    H, P, L, n = 49, 1_560_000, 16, 60_000_000
    need = hb.solve_bytes(H, P, L, n, False)
    assert need > hb.solve_bytes(H, P, L, n, True)
    cuda = torch.device("cuda")
    cached = 1 << 30   # reserved by the allocator, not allocated
    monkeypatch.delenv("PHI_TPU_STREAM_W", raising=False)
    monkeypatch.delenv("PHI_TPU_STREAM_W_GB", raising=False)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 5 * cached)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 4 * cached)
    for free, streams in ((need - cached, False), (need - cached - 1, True)):
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda d, f=free: (f, 80 * 10 ** 9))
        assert tdp.stream_w(H, P, L, n, cuda) is streams
    monkeypatch.setenv("PHI_TPU_STREAM_W_GB", str(L * H * P * 4 / 2 ** 30))
    assert not tdp.stream_w(H, P, L, n, cuda)
    monkeypatch.setenv("PHI_TPU_STREAM_W_GB", str(L * H * P * 4 / 2 ** 30
                                                 - 1e-3))
    assert tdp.stream_w(H, P, L, n, cuda)
    # the model's own choice at a capacity: the same flip, with what the
    # solve finds allocated (the retained columns, the statics and what
    # the graph's memo keeps: walk_mat and its hashes, the packed batches)
    # held
    monkeypatch.delenv("PHI_TPU_STREAM_W_GB")
    kw = dict(windows=10 ** 9, n_vtx=P, n_esrc=H * P // 16,
              pack_slot=10 ** 8)
    held = hb.budget(H, P, L, 10 ** 6, n, 10 ** 8, stream_w=False,
                     capacity=1 << 40, **kw)["per_device_bytes"]["solve"]
    held = sum(v for k, v in held.items()
               if k.startswith(("switch", "occ", "packed", "held by")))
    for cap, streams in ((held + need, False), (held + need - 1, True)):
        got = hb.budget(H, P, L, 10 ** 6, n, 10 ** 8, capacity=cap, **kw)
        assert got["stream_w"] is streams


def test_cli_prints_one_line_per_mesh(capsys):
    assert hb.main(["--H", "49", "--P", "1560000", "--mesh", "1,4",
                    "--capacity-gb", "80"]) == 0
    import json
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["sp_shards"] for ln in lines] == [1, 4]
    assert all(ln["fits"] and ln["total_bytes"] > 0 for ln in lines)


def test_hit_path_rows_equal_the_port_tensors(tmp_path, monkeypatch):
    """Above MAX_HAPS walks the anchors stage is the hit path's: the
    mixed table join_many builds, the bytes a batch holds on the device
    until its harvest (its uploaded inputs and join_rows' outputs), and
    the peak of new tensors alive in one join_rows, with the rows kernel's
    outputs allocated as its launch allocates them."""
    from phi_tpu_torch.ops import search
    from phi_tpu_torch.sketch import kernels as tk
    k, w, R, SB = 21, 11, 2, 2
    (_, graph), reads = _instance(tmp_path)
    spectrum = _spectrum(reads, k, w)
    n_sp = len(spectrum[0])
    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    seen = {}
    _spy(monkeypatch, search, "mixed_tensors", seen)
    monkeypatch.setattr(tk, "ROWS", R)
    monkeypatch.setattr(tk, "SUPER_BLOCKS", SB)
    tk.join_many(seqs, k, w, spectrum[0], spectrum[1], device="cpu")
    table = seen["mixed_tensors"][0][1]
    rows = hb.hit_path_rows(n_sp, w)
    assert _nbytes(*table[:4]) == hb.mixed_table_bytes(n_sp) == \
        rows["spectrum probe table (int64)"]

    row_lanes = (SB + 1) * tk.BLK
    _, plan = tk.plan_join_rows(seqs, k, w, SB)
    tens = tk.pack_join_host(seqs, plan[:R], row_lanes)
    codes = tk.unpack_2bit(tens[0], row_lanes)
    planes = tk.sketch_rows_torch(codes, tens[1], tens[2], k, w)
    # the launch's outputs: fresh key, pos and emit planes of these dtypes
    monkeypatch.setattr(tk, "sketch_rows",
                        lambda *a: tuple(t.clone() for t in planes))
    caps = (tk.emit_cap(w, SB), tk.hit_cap(w, SB, R))
    with LiveBytes() as lb:
        out = tk.join_rows(*tens, table, k, w, SB, *caps)
    assert lb.peak == rows[
        "one batch's join temporaries (kernel planes, compaction)"]
    assert (tk.WINDOW + 1) * (_nbytes(*tens) + _nbytes(*out)) == rows[
        "join batches in flight (WINDOW + 1: packed codes, hit columns)"]

    monkeypatch.undo()
    H, P = 256, 1000
    got = hb.budget(H, P, 4, n_sp, 10 ** 4, 10 ** 6, windows=10 ** 7, w=w,
                    capacity=1 << 40)
    anchors = got["per_device_bytes"]["anchors"]
    assert hb.hit_path_rows(n_sp, w).items() <= anchors.items()
    assert not [r for r in anchors if r.startswith(
        ("hit buffers", "walk_mat", "filter", "occurrence"))]
    wm_row = ("held by the graph: walk_mat and prefix hashes (walk_mat <= "
              "WALK_HASHES_MAX_BYTES)")
    assert got["per_device_bytes"]["solve"][wm_row] == 0
    # the statics are held at any size, the walk hashes only below theirs
    assert anchors["held by the graph: switch sources and lane tables"] > 0
    narrow = hb.budget(H - 1, P, 4, n_sp, 10 ** 4, 10 ** 6, windows=10 ** 7,
                       w=w, capacity=1 << 40)["per_device_bytes"]
    assert "hit buffers (3x int64 x CAP)" in narrow["anchors"]
    assert narrow["solve"][wm_row] > 0
    monkeypatch.setattr(pangenome, "WALK_HASHES_MAX_BYTES", 4 * (H - 1) * P
                        - 1)
    assert hb.budget(H - 1, P, 4, n_sp, 10 ** 4, 10 ** 6, windows=10 ** 7,
                     w=w, capacity=1 << 40)["per_device_bytes"]["solve"][
                         wm_row] == 0
