"""End-to-end orchestration on one torch device or a mesh of them: graph +
reads -> inferred haplotype FASTA. The counterpart of `phi_tpu/pipeline.py`,
with the same [M::] phase-log lines and the same `timings` keys.

Stages: graph ingest (held between runs on the unchanged file:
graph/pangenome.py's held panel) and the read spectrum on the host
(native C++; with PHI_TPU_DEVICE_READ_SKETCH=1 the seq kernel on the
device, `sketch.minimizer.sketch_read_concat`); then one of two anchor
routes:
  * the device anchors (the default): the haplotype sketch, join and
    threshold filter on the device (anchors/device.py, through the rows3,
    rows3w or rows2 kernel);
  * the hit path (`--save-index`, an empty read spectrum, or where the
    device anchors return None, as the reference's do: walks holding N,
    more than 255 haplotypes, k + w - 2 beyond the kernels' halo, wide k
    off the cuckoo table, overflows; and k-mers that may span more than 63
    walk positions, across chains of empty nodes, which the kernels'
    6-bit span would clamp): per-haplotype hits from the v1 join
    on the device (`sketch.kernels.join_many`, the rows kernel, with the
    native host join for walks holding N) or, for k > 31 or k + w - 2
    beyond the halo, from the native host join of every walk
    (`sketch.minimizer.sketch_join_walks`); the anchor tables are built
    on the host (anchors/join.py). `--save-index` writes the spectrum and
    hits, and `--load-index` reads them back instead of the reads, so a
    re-solve with other solver parameters skips all sketching
    (checkpoint.py).
Then the exact-credit DP on the device (solve/dp.py), or, where spans
need more than MAX_LAYERS straddle layers, the bracket solve (the search
and the optimistic fixpoints, both decoded); decode, the Lagrangian /
subgradient / exact / branch-and-bound certification ladder and emit on
the host.

On a mesh (`mesh`, or `opt.mesh_devices` > 1: `--mesh N`, N devices of
`device`'s type, which for cuda must be visible cards), as in phi_tpu: the
reads are split over every device of the mesh and sketched by the seq
kernel on each (parallel/sharded.py's dp axis); the device anchors are
bypassed, and the hit path joins with join_many round-robined over the
mesh's devices (the rows kernel), plus the host joins above; every solve
of the ladder is sharded over hap x sp (`parallel.sharded.solve_dp_sharded`,
which decodes the search fixpoint in bracket mode).

With `-d` (opt.debug) the run also prints the reference's k-mer sharing
histogram (after the sketch), a model dump and the chosen path's `[D]`
segment lines (after the solve).
"""

from __future__ import annotations

import dataclasses
from time import perf_counter

import numpy as np
import torch

from phi_tpu_torch import logging as plog
from phi_tpu_torch import native
from phi_tpu_torch.anchors.device import (ANCHOR_ROUTE_STATS,
                                          HITS_SLOT_STATS, graph_fingerprint,
                                          join_anchors_device)
from phi_tpu_torch.anchors.join import (AnchorTables, anchor_tables_from_hits,
                                        sketch_haplotypes)
from phi_tpu_torch.checkpoint import load_index, save_index
from phi_tpu_torch.config import Options
from phi_tpu_torch.emit import recombination_report
from phi_tpu_torch.graph.pangenome import (PangenomeGraph, held_panel,
                                          hold_panel, panel_key, tensorize)
from phi_tpu_torch.io.fasta import hap_name_from_paths, write_fasta
from phi_tpu_torch.io.gfa import read_gfa
from phi_tpu_torch.io.reads import load_read_batch
from phi_tpu_torch.parallel.sharded import Mesh, make_mesh, solve_dp_sharded
from phi_tpu_torch.sketch.encode import combine64
from phi_tpu_torch.sketch.kernels import HALO_PAD, NARROW_MAX_K, join_many
from phi_tpu_torch.sketch.minimizer import (NO_NATIVE, host_join_many,
                                            native_spectrum,
                                            sketch_join_walks,
                                            sketch_read_concat)
from phi_tpu_torch.solve.decode import (DecodeResult, covered_occurrences,
                                       decode_path)
from phi_tpu_torch.solve.dp import solve_dp, solve_dp_both
from phi_tpu_torch.solve.prep import build_solver_tables, solver_layers
from phi_tpu_torch.trace import recording, span


@dataclasses.dataclass
class PipelineResult:
    sequence: str
    decode: DecodeResult
    anchors: AnchorTables
    recombination_count: int
    report_segments: list[str]
    graph: PangenomeGraph
    timings: dict[str, float]
    # the hit path's per-hap (n_minimizers, positions, spectrum ids); None
    # when the device anchors ran
    hits: list | None = None


def resolve_device(device) -> torch.device:
    """The run's device; a CUDA device must exist (no CPU stand-in)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but no CUDA device is "
                           "available (torch.cuda.is_available() is false)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def native_available() -> bool:
    """Whether the native host library (graph ingest, read spectrum) loads;
    `make -C native` builds it on first use."""
    return native.available()


def read_spectrum(reads, k: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """Distinct canonical minimizers of the reads as (hi, lo) uint32, from
    the native per-read scan; for k > 31 the keys are the 64-bit folds
    (fold128_64) of the 126-bit canonical k-mers."""
    return native_spectrum(reads.concat, reads.off, k, w)


def mesh_for(n: int, device) -> Mesh:
    """The mesh of `--mesh n` on `device`'s type: n visible cards for cuda
    (a ValueError naming the count when fewer are visible), n CPU shards
    for cpu."""
    device = torch.device(device)
    if device.type == "cpu":
        return make_mesh(n, devices=[device] * n)
    return make_mesh(n)


def run_pipeline(gfa_path: str, reads_path: str | None, out_path: str | None,
                 opt: Options, device="cuda", mesh: Mesh | None = None
                 ) -> PipelineResult:
    """One inference. `mesh` (or opt.mesh_devices > 1, a mesh_for `device`)
    shards the read sketch, the join and every solve over its devices.
    The result's `timings` are the run's spans (trace.py): the phases
    load_graph, load_reads, sketch_reads, sketch_haps, anchors, solve,
    report and emit (and -d's debug_histogram, debug_dump), their parts as
    `<phase>_<part>`, and total."""
    device = resolve_device(device)
    if mesh is None and opt.mesh_devices and opt.mesh_devices > 1:
        mesh = mesh_for(opt.mesh_devices, device)
    if not native_available():
        raise RuntimeError(NO_NATIVE)
    if opt.num_threads:
        native.set_threads(opt.num_threads)
    with recording() as timings:
        t0 = perf_counter()
        res = _run(gfa_path, reads_path, out_path, opt, device, mesh,
                   timings)
        timings["total"] = perf_counter() - t0
    return res


def _run(gfa_path: str, reads_path: str | None, out_path: str | None,
         opt: Options, device, mesh: Mesh | None, timings: dict
         ) -> PipelineResult:
    """run_pipeline's phases, each a span of the run's recorder."""
    with span("load_graph"):
        # the held panel: the graph an earlier run loaded from this
        # unchanged file, else a new parse and tensorize
        with span("parse"):
            key = panel_key(gfa_path)
            graph = held_panel(key)
            if graph is None:
                gfa = read_gfa(gfa_path)
        held = graph is not None
        with span("tensorize"):
            if not held:
                graph = tensorize(gfa)
        if graph.n_vtx == 0:
            raise ValueError(f"no segments parsed from {gfa_path} "
                             "(is it a GFA v1.1 file?)")
        if graph.num_walks == 0:
            raise ValueError(f"{gfa_path} has no W-line haplotype walks; "
                             "PHI requires walks (convert VCF input with "
                             "python -m phi_tpu_torch.vcfio.vcf2graph -v "
                             "VCF -r REF.fa)")
        if not held:
            hold_panel(key, graph)
        plog.log("main", f"Loaded graph from: {gfa_path}")

    hits = None
    if opt.load_index:
        # the checkpoint: the spectrum and the per-hap join hits of an
        # earlier --save-index run; parameter re-solves skip sketching
        timings["load_reads"] = 0.0
        timings["sketch_reads"] = 0.0
        with span("sketch_haps"):
            spectrum, hits, meta = load_index(opt.load_index)
            if meta and (int(meta.get("k", opt.k)) != opt.k
                         or int(meta.get("w", opt.w)) != opt.w):
                raise ValueError(
                    f"index {opt.load_index} was built with "
                    f"k={meta.get('k')} w={meta.get('w')}, run requests "
                    f"k={opt.k} w={opt.w}")
            if len(hits) != graph.num_walks:
                raise ValueError(
                    f"index {opt.load_index} has {len(hits)} haplotypes, "
                    f"graph has {graph.num_walks}")
            plog.log("ILP_function",
                     f"Loaded index from {opt.load_index}: spectrum "
                     f"{len(spectrum[0])}, {graph.num_walks} haplotypes")
    else:
        with span("load_reads"):
            reads = load_read_batch(reads_path)
        plog.log("ILP_function",
                 f"Graph has {graph.n_vtx} vertices, {graph.num_walks} walks "
                 f"and read has {reads.n_reads} reads")
        with span("sketch_reads"):
            spectrum = sketch_read_concat(
                reads.concat, reads.off, opt.k, opt.w,
                devices=mesh.flat if mesh else None, device=device)

        with span("sketch_haps"):
            plog.raw("Number of Minimizers")
            with span("walk_codes"):
                hap_codes = [graph.walk_seq_codes(h)
                             for h in range(graph.num_walks)]
            dres = None
            if not opt.save_index and mesh is None and len(spectrum[0]):
                # haplotype sketch + join + threshold filter, on the
                # device; None where the reference leaves it for the hit
                # path
                dres = join_anchors_device(
                    graph, hap_codes, opt.k, opt.w, spectrum[0],
                    spectrum[1], opt.threshold, device=device)
            if dres is None:
                hits = _join_hits(graph, hap_codes, opt, spectrum, device,
                                  mesh.flat if mesh else None)
                per_hap_min = [n for n, _, _ in hits]
            else:
                per_hap_min, dev_occ = dres
                anchors = AnchorTables.on_device(per_hap_min, dev_occ,
                                                 len(spectrum[0]))
            for h in range(graph.num_walks):
                plog.raw(f"{graph.walk_names[h]} : {per_hap_min[h]}")
            plog.log("ILP_function", "Haplotypes sketched")
        plog.log("ILP_function",
                 f"Indexed reads with spectrum size: {len(spectrum[0])}")
        if opt.save_index:
            with span("save_index"):
                save_index(opt.save_index, spectrum, hits,
                           meta={"k": opt.k, "w": opt.w})
            plog.log("ILP_function", f"Index saved to {opt.save_index}")

    if opt.debug:
        with span("debug_histogram"):
            _debug_sharing_histogram(graph, opt, device)

    # --- anchor tables (host, on the hit path) + the log contract ---
    with span("anchors"):
        if hits is not None:
            with span("native"):
                anchors = anchor_tables_from_hits(
                    graph, opt.k, hits, len(spectrum[0]), opt.threshold)
        ANCHOR_ROUTE_STATS["hits" if hits is not None
                           else anchors.device_occ.route] += 1
        plog.raw("Number of Anchors")
        for h in range(graph.num_walks):
            plog.raw(f"{graph.walk_names[h]} : {anchors.per_hap_anchors[h]}")
        sp = max(anchors.spectrum_size, 1)
        plog.log("ILP_function",
                 f"Filtered/Retained Minimizers: "
                 f"{anchors.filtered_kmers / sp * 100:.2f}/"
                 f"{(sp - anchors.filtered_kmers) / sp * 100:.2f}%")
        plog.log("ILP_function",
                 f"{anchors.n_model_kmers * 100.0 / sp:.2f}% Minimizers are "
                 "in ILP")

    # --- solve ---
    mode = ("QP" if opt.is_qclp else "ILP")
    plog.log("ILP_function", f"{mode} model started")
    plog.log("ILP_function",
             "Using Mixed Integer Programming" if opt.is_mixed
             else "Using Integer Programming")
    plog.log("ILP_function",
             f"Compat: -q{opt.is_qclp} -m{opt.is_mixed} -N{opt.is_naive_exp} "
             f"select equivalent formulations (DP solves the shared optimum "
             f"directly); -c {opt.max_occ} accepted, unused")
    with span("solve"):
        result = _solve_with_refinement(graph, anchors, opt, device, mesh)
        plog.log("ILP_function", "Model optimized")
        plog.log("ILP_function",
                 f"DP sweeps: {result.n_sweeps}; lower bound: "
                 f"{result.dp_objective:.3f}; path objective: "
                 f"{result.true_objective:.3f}; gap: "
                 f"{max(0.0, result.true_objective - result.dp_objective):.3f}")

    if opt.debug:
        # the reference's -d detail: a model dump and the chosen path
        with span("debug_dump"):
            _debug_model_dump(graph, anchors, opt)
            for (sh, sq, sp) in result.segments:
                plog.raw(f"[D] segment lane={graph.walk_names[sh]} "
                         f"walk_pos=[{sq},{sp}] vertices=["
                         f"{graph.walk_mat[sh, sq]}.."
                         f"{graph.walk_mat[sh, sp]}]")
            plog.raw(f"[D] matched distinct k-mers: "
                     f"{result.matched_distinct} / {anchors.n_model_kmers}; "
                     f"weighted occurrence credit: "
                     f"{result.matched_total:.1f}")

    # --- report + emit ---
    with span("report"):
        recomb, segs = recombination_report(graph, result.vertices,
                                            result.vertex_hap)
        plog.raw(f"Recombination count: {recomb}")
        plog.raw("Recombined haplotypes: " + "".join(segs))

    with span("emit"):
        with span("path_seq"):
            seq = graph.path_seq(result.vertices)
        if out_path is not None:
            with span("write"):
                name = hap_name_from_paths(
                    gfa_path, reads_path or opt.load_index or "index")
                write_fasta(out_path, name, seq)
            plog.log("ILP_function",
                     f"Haplotype of size: {len(seq)} written to: {out_path}")
    return PipelineResult(
        sequence=seq, decode=result, anchors=anchors,
        recombination_count=recomb, report_segments=segs,
        graph=graph, timings=timings, hits=hits)


def _debug_sharing_histogram(graph: PangenomeGraph, opt: Options,
                             device) -> None:
    """The reference's debug k-mer sharing histogram: for each distinct
    haplotype minimizer, in how many walks it occurs, printed as shared
    fractions. The walks are sketched on `device` (the seq kernel), and
    the distinct keys are counted there too: on the host, the per-walk
    sorts took most of a -d run at 49 x 5 Mbp."""
    sketches = sketch_haplotypes(graph, opt.k, opt.w, device=device)
    parts = [torch.unique(torch.from_numpy(combine64(hi, lo).view(np.int64))
                          .to(device)) for hi, lo, _ in sketches]
    cnt = torch.unique(torch.cat(parts), return_counts=True)[1]
    hist = torch.bincount(cnt, minlength=graph.num_walks + 1).cpu().numpy()
    total = max(len(cnt), 1)
    plog.raw("Shared fraction of unique kmers by haplotypes")
    for i in range(1, graph.num_walks + 1):
        plog.raw(f"[Haplotypes: {i}, fraction of unique shared kmers: "
                 f"{hist[i] / total:.5f}]")


_DUMP_MAX_STATES = 20_000
_DUMP_MAX_ROWS = 50_000


def _debug_model_dump(graph: PangenomeGraph, anchors: AnchorTables,
                      opt: Options) -> None:
    """The reference's -d model dump: the credit tables per lane, every
    switch edge with its cost and every occurrence interval; a larger
    model prints one summary line instead."""
    anchors.materialize_device()
    t = build_solver_tables(graph, anchors, opt.recombination,
                            solver_layers(graph, opt.k))
    H, P = t.state_vertex.shape
    n_occ = len(anchors.occ_hap)
    if (H * P > _DUMP_MAX_STATES or len(t.esrc_h) > _DUMP_MAX_ROWS
            or n_occ > _DUMP_MAX_ROWS):
        plog.raw(f"[D] model dump skipped (too large): {H}x{P} lane states, "
                 f"{len(t.esrc_h)} switch edges, {n_occ} occurrences")
        return
    t = t.dense()
    plog.raw(f"[D] objective: minimize {t.R:g}*switches - covered_credit "
             f"+ {t.const:g}")
    for h in range(H):
        L = int(t.walk_len[h])
        s_row = " ".join(f"{t.S[h, p]:g}" for p in range(L))
        b_row = " ".join(f"{t.B[h, p]:g}" for p in range(L))
        plog.raw(f"[D] lane {graph.walk_names[h]}: S=[{s_row}] B=[{b_row}]")
    for i in range(len(t.esrc_h)):
        h, p = int(t.esrc_h[i]), int(t.esrc_p[i])
        plog.raw(f"[D] switch ({graph.walk_names[h]},{p}) -> "
                 f"vertex {int(t.esrc_target[i])} cost {t.R:g}")
    for i in range(n_occ):
        plog.raw(f"[D] occ kmer={int(anchors.occ_kmer[i])} "
                 f"lane={graph.walk_names[int(anchors.occ_hap[i])]} "
                 f"span=[{int(anchors.occ_start[i])},"
                 f"{int(anchors.occ_end[i])}) "
                 f"weight={float(anchors.occ_weight[i]):g}")


def _join_hits(graph, hap_codes, opt: Options, spectrum, device,
               devices=None):
    """The hit path's join: per-hap (n_minimizers, positions, spectrum ids).
    For k <= 31 within the kernels' halo, join_many on the device (walks
    round-robined over `devices` on a mesh), and the native host join for
    each walk it hands back (walks holding N); for k > 31 or k + w - 2
    beyond the halo, the native host join of every walk (the reference's
    choice, pipeline.py:217-232 of the JAX package). On one device
    join_many is given the graph's content fingerprint, so it may serve
    the walks' packed batches from the packed-batch slot; a mesh, or a
    graph too large to fingerprint, packs every join (a miss of
    HITS_SLOT_STATS). One span, `hits`, so its parts (fingerprint and
    join_many's plan, cuckoo and join) key apart from the device anchors'
    spans of the same names."""
    with span("hits"):
        if opt.k > NARROW_MAX_K or opt.k + opt.w - 2 > HALO_PAD:
            return sketch_join_walks(graph, opt.k, opt.w, *spectrum)
        panel = None
        if devices is None:
            with span("fingerprint"):
                panel = graph_fingerprint(graph)
        if panel is None:
            HITS_SLOT_STATS["misses"] += 1
        hits = join_many(hap_codes, opt.k, opt.w, *spectrum, device=device,
                         devices=devices, panel=panel)
        left = [h for h, out in enumerate(hits) if out is None]
        for h, out in zip(left, host_join_many(hap_codes, left, opt.k,
                                               opt.w, *spectrum)):
            hits[h] = out
    return hits


def _hydrate_tables(tables, anchors) -> None:
    """Fill the host occurrence columns (decode's lazy straddle and S_row
    reads need them) from the device anchors."""
    with span("hydrate"):
        anchors.materialize_device()
    if tables.occ_hap is None:
        tables.occ_hap = anchors.occ_hap
        tables.occ_start = anchors.occ_start
        tables.occ_end = anchors.occ_end
        tables.occ_weight = anchors.occ_weight


def _solve_and_decode(graph, tables, anchors, opt: Options, device,
                      mesh: Mesh | None = None) -> DecodeResult:
    """Exact mode (tables.n_layers set): one exact-credit fixpoint, whose
    decoded path is the optimal relaxed path and its value a valid bound.
    Bracket mode: the search and the optimistic fixpoints are both decoded
    and the path with the lower exact objective is kept; the bound is the
    optimistic fixpoint's. On a mesh, solve_dp_sharded, and its one
    solution decoded (the JAX package's mesh branch)."""
    if mesh is not None:
        _hydrate_tables(tables, anchors)
        M, ends, sweeps, lb = solve_dp_sharded(tables, mesh, opt.max_sweeps)
        return decode_path(graph, tables, anchors, M, ends, sweeps, lb)
    if tables.n_layers is not None:
        M, ends, sweeps, lb = solve_dp(tables, opt.max_sweeps, device)
        _hydrate_tables(tables, anchors)
        return decode_path(graph, tables, anchors, M, ends, sweeps, lb)
    _hydrate_tables(tables, anchors)
    with span("tables"):
        tables = tables.dense()
    (M, ends), (M_opt, ends_opt), sweeps, lb = solve_dp_both(
        tables, opt.max_sweeps, device)
    best = decode_path(graph, tables, anchors, M, ends, sweeps, lb)
    try:
        t_opt = dataclasses.replace(tables, S=tables.B, n_layers=None)
        cand = decode_path(graph, t_opt, anchors, M_opt, ends_opt, sweeps,
                           lb)
        if cand.true_objective < best.true_objective:
            best = cand
    except RuntimeError:
        pass  # the optimistic backtrace can fail on ties; the search path stands
    return best


def gap_tol(R: float) -> float:
    """Certification tolerance for the duality gap. Objective differences
    are a*R + b with integer a and b, so with integer R any two distinct
    values differ by >= 1 and 1 - eps certifies; with fractional R < 1 the
    smallest step is R itself; fractional R >= 1 keeps 0.5."""
    if R > 0 and float(R).is_integer():
        return 0.99   # 0.01 margin over observed f32 bound noise (~1e-3)
    return 0.5 * min(1.0, R) if R > 0 else 0.0


def _solve_with_refinement(graph: PangenomeGraph, anchors: AnchorTables,
                           opt: Options, device,
                           mesh: Mesh | None = None) -> DecodeResult:
    """One DP solve; if the decoded path's exact objective is above the DP
    bound (duplicate k-mer credit), Lagrangian reweighting rounds, then the
    exact small-case enumeration, projected subgradient ascent and
    branch-and-bound, each only while the gap stays above gap_tol."""
    from phi_tpu_torch.solve.prep import _bucket_layers
    with span("prep"):
        layers = solver_layers(graph, opt.k)
        # shrink the W stack to the spans actually present (no compile
        # cache to keep stable, so every route shrinks, as phi_tpu does on
        # its CPU backend)
        if anchors.device_occ is not None:
            max_span = anchors.device_occ.max_span
        else:
            max_span = int((anchors.occ_end - anchors.occ_start).max()) \
                if len(anchors.occ_hap) else 0
        if max_span > 0:
            layers = min(layers, _bucket_layers(max_span - 1))
    tables = build_solver_tables(graph, anchors, opt.recombination, layers)
    best = _solve_and_decode(graph, tables, anchors, opt, device, mesh)
    best_bound = best.dp_objective
    rounds = opt.lagrangian_rounds
    tol = gap_tol(opt.recombination)
    if best.true_objective - best_bound <= tol or rounds <= 0:
        best.dp_objective = best_bound
        return best

    n_kmer_ids = int(anchors.occ_kmer.max()) + 1 if len(anchors.occ_kmer) else 0
    mu = np.ones(n_kmer_ids, np.float32)
    best_mu = mu  # multipliers achieving best_bound (branch-and-bound root)
    relax_path = best  # the relaxation argmin path under the current mu
    stall = 0
    escalated = False
    it = -1
    while it + 1 < rounds:
        it += 1
        # covered-occurrence multiplicity per k-mer on the relaxation path
        covered = covered_occurrences(anchors, relax_path.segments)
        mult = np.bincount(anchors.occ_kmer[covered], minlength=n_kmer_ids)
        dup = mult >= 2
        release = (mult == 0) & (mu < 1.0)
        if not dup.any() and not release.any():
            break
        # duplicated k-mers jump to mu = 0 (dual-optimal for this path);
        # released ones ascend back by a Polyak step
        mu[dup] = 0.0
        if release.any():
            g = np.zeros(n_kmer_ids)
            g[release] = -1.0
            step = max(best.true_objective - best_bound, 0.1) / float(release.sum())
            mu = np.clip(mu - step * g, 0.0, 1.0).astype(np.float32)
        anchors_w = dataclasses.replace(
            anchors, occ_weight=mu[anchors.occ_kmer])
        tables = build_solver_tables(graph, anchors_w, opt.recombination,
                                     layers)
        cand = _solve_and_decode(graph, tables, anchors_w, opt, device, mesh)
        relax_path = cand
        improved = cand.dp_objective > best_bound + 1e-6
        if improved:
            best_mu = mu.copy()
        best_bound = max(best_bound, cand.dp_objective)
        if cand.true_objective < best.true_objective - 1e-6:
            best = cand
            improved = True
        if best.true_objective - best_bound <= tol:
            break
        stall = 0 if improved else stall + 1
        if stall >= 3:
            if escalated or best.true_objective - best_bound <= tol:
                break
            # the gap is still open: double the multiplier budget once
            escalated = True
            rounds += max(rounds, 4)
            stall = 0
            plog.log("ILP_function",
                     f"Gap {best.true_objective - best_bound:.3f} > "
                     f"{tol:g} after {it + 1} rounds; escalating to {rounds}")
    if best.true_objective - best_bound > tol:
        cand = _exact_small_case(graph, anchors, opt)
        if cand is not None:
            exact_obj, exact_res = cand
            if exact_res.true_objective < best.true_objective:
                best = exact_res
            best_bound = max(best_bound, exact_obj)
            plog.log("ILP_function",
                     f"Exact small-case enumeration closed the gap: "
                     f"optimum {exact_obj:.3f}")
    if best.true_objective - best_bound > tol and n_kmer_ids:
        best_mu, best_bound, best = _subgradient_phase(
            graph, anchors, opt, layers, best_mu, best_bound, best, tol,
            device, mesh)
    if best.true_objective - best_bound > tol:
        import os
        from phi_tpu_torch.solve.bnb import branch_and_bound
        bb_best, bb_bound = branch_and_bound(
            graph, anchors, opt, tol,
            mu=best_mu if n_kmer_ids else None, incumbent=best,
            max_nodes=int(os.environ.get("PHI_TPU_BNB_NODES", "48")),
            max_seconds=float(os.environ.get("PHI_TPU_BNB_SECS", "120")),
            layers=layers, device=device, mesh=mesh)
        if bb_best.true_objective < best.true_objective:
            best = bb_best
        best_bound = max(best_bound, bb_bound)
        plog.log("ILP_function",
                 f"Branch-and-bound: bound {bb_bound:.3f}, incumbent "
                 f"{best.true_objective:.3f}, gap "
                 f"{max(0.0, best.true_objective - best_bound):.3f}")
    best.dp_objective = best_bound
    return best


def _subgradient_phase(graph: PangenomeGraph, anchors, opt: Options,
                       layers, mu0: np.ndarray, best_bound: float, best,
                       tol: float, device, mesh: Mesh | None = None,
                       max_iters: int = 40):
    """Projected subgradient ascent on the Lagrangian dual from mu0:
    g_i = 1 - (covered multiplicity of k-mer i on the relaxation argmin),
    Polyak step (UB - L)/||g||^2 with backoff on stall. Returns
    (best_mu, best_bound, best incumbent)."""
    import os
    max_iters = int(os.environ.get("PHI_TPU_SUBGRAD_ITERS", max_iters))
    mu = mu0.astype(np.float64).copy()
    best_mu = mu0
    lam = 1.0
    stall = 0
    n_kmer_ids = len(mu)
    for _ in range(max_iters):
        anchors_w = dataclasses.replace(
            anchors, occ_weight=mu.astype(np.float32)[anchors.occ_kmer])
        tables = build_solver_tables(graph, anchors_w, opt.recombination,
                                     layers)
        cand = _solve_and_decode(graph, tables, anchors_w, opt, device, mesh)
        improved = cand.dp_objective > best_bound + 1e-6
        if improved:
            best_bound = cand.dp_objective
            best_mu = mu.astype(np.float32).copy()
        if cand.true_objective < best.true_objective - 1e-6:
            best = cand
        if best.true_objective - best_bound <= tol:
            break
        covered = covered_occurrences(anchors, cand.segments)
        mult = np.bincount(anchors.occ_kmer[covered], minlength=n_kmer_ids)
        g = 1.0 - mult.astype(np.float64)
        gnorm = float((g * g).sum())
        if gnorm <= 0:
            break
        step = lam * max(best.true_objective - cand.dp_objective, 0.05) \
            / gnorm
        mu = np.clip(mu + step * g, 0.0, 1.0)
        stall = 0 if improved else stall + 1
        if stall >= 6:
            lam *= 0.5
            stall = 0
            if lam < 1e-3:
                break
    return best_mu, best_bound, best


# expanded-graph size caps under which exhaustive enumeration is cheap
_EXACT_MAX_STATES = 3000
_EXACT_MAX_EDGES = 6000


def _exact_small_case(graph: PangenomeGraph, anchors: AnchorTables,
                      opt: Options):
    """Brute-force the expanded graph when it is small enough; returns
    (exact objective, DecodeResult-shaped path) or None."""
    from phi_tpu_torch.solve.decode import result_from_segments
    from phi_tpu_torch.solve.exact import brute_force_optimum
    from phi_tpu_torch.solve.prep import switch_sources_cached
    H, P = graph.walk_mat.shape
    if (H * P > _EXACT_MAX_STATES
            or len(switch_sources_cached(graph)[0]) > _EXACT_MAX_EDGES):
        return None
    tables = build_solver_tables(graph, anchors, opt.recombination,
                                 solver_layers(graph, opt.k))
    try:
        exact, segs = brute_force_optimum(graph, tables, anchors)
    except RuntimeError:  # too many paths
        return None
    if segs is None:
        return None
    return exact, result_from_segments(graph, tables, anchors, segs, exact)
