"""Baseline methods for accuracy comparisons (the port's copy of
`phi_tpu/eval/baselines.py`, on the port's pipeline and `device`).

The reference benchmarks against VG giraffe/call and PanGenie
(data/run_VG.py, data/run_PG.py) — neither tool is part of this project, so
the role of "context for PHI's accuracy" is filled by native baselines:

- best_panel_hap: the panel walk sharing the most read minimizers, emitted
  as-is (no recombination). This is the floor any single-haplotype method
  (reference-based imputation at its best) could reach — PHI's headline is
  beating it at low coverage by recombining walks.
- the greedy per-site stand-in: the PHI solve at a near-zero recombination
  penalty without distinct-credit refinement.
"""

from __future__ import annotations

import numpy as np
import torch

from phi_tpu_torch.graph.pangenome import PangenomeGraph
from phi_tpu_torch.sketch.encode import combine64


def best_panel_hap(graph: PangenomeGraph,
                   spectrum: tuple[np.ndarray, np.ndarray],
                   k: int, w: int, device="cuda") -> tuple[int, str]:
    """(hap_index, sequence) of the walk with the most distinct read-spectrum
    minimizers; ties go to the first such walk. The walks are sketched on
    `device` (`anchors.join.sketch_haplotypes`: the seq kernel, one launch
    per walk, for k <= 31; the native scan above), and each walk's distinct
    keys and their membership in the spectrum are counted there too, not
    walk by walk on the host."""
    from phi_tpu_torch.anchors.join import sketch_haplotypes
    from phi_tpu_torch.pipeline import resolve_device
    device = resolve_device(device)
    sp_key = torch.from_numpy(combine64(*spectrum).view(np.int64)).to(device)
    counts = []
    for hi, lo, _ in sketch_haplotypes(graph, k, w, device=device):
        key = torch.from_numpy(combine64(hi, lo).view(np.int64)).to(device)
        counts.append(torch.isin(torch.unique(key), sp_key).sum())
    # the first of the largest counts, as the reference's strict > keeps
    best_h = int(np.argmax(torch.stack(counts).cpu().numpy()))
    return best_h, graph.path_seq(
        graph.walk_mat[best_h, :graph.walk_len[best_h]])


def run_best_hap_baseline(gfa_path: str, reads_path: str, truth_path: str,
                          k: int = 31, w: int = 25, device="cuda") -> dict:
    """File-level runner mirroring run_matrix's cell metrics. The read
    spectrum is the native scan's (`pipeline.read_spectrum`), as the JAX
    package's `sketch_read_concat` takes it."""
    import time

    from phi_tpu_torch.eval.edits import _read_fasta_first_seq, edit_stats
    from phi_tpu_torch.graph.pangenome import tensorize
    from phi_tpu_torch.io.gfa import read_gfa
    from phi_tpu_torch.io.reads import load_read_batch
    from phi_tpu_torch.pipeline import read_spectrum, resolve_device
    device = resolve_device(device)
    t0 = time.time()
    graph = tensorize(read_gfa(gfa_path))
    spectrum = read_spectrum(load_read_batch(reads_path), k, w)
    h, seq = best_panel_hap(graph, spectrum, k, w, device)
    truth = _read_fasta_first_seq(truth_path)
    st = edit_stats(seq, truth)
    return {"hap": graph.walk_names[h], "edit_distance": st.edit_distance,
            "time_s": round(time.time() - t0, 2)}


def run_greedy_baseline(gfa_path: str, reads_path: str, truth_path: str,
                        k: int = 31, w: int = 25, device="cuda") -> dict:
    """Greedy per-site genotyping stand-in (the VG-call/PanGenie model
    class, data/run_VG.py / run_PG.py): every variant site is decided by
    local read-k-mer support alone — implemented as the PHI solve with a
    near-zero recombination penalty and no distinct-credit refinement, so
    switching between walks is free and duplicate k-mer credit is kept.
    PHI's headline is that joint inference (R=100 + global credit) beats
    this at low coverage, where per-site votes chase sequencing errors."""
    import os
    import tempfile
    import time

    from phi_tpu_torch import pipeline
    from phi_tpu_torch.config import Options
    from phi_tpu_torch.eval.edits import _read_fasta_first_seq, edit_stats
    device = pipeline.resolve_device(device)
    t0 = time.time()
    out = tempfile.NamedTemporaryFile(suffix=".fa", delete=False)
    out.close()
    try:
        opt = Options(k=k, w=w, recombination=1e-3, lagrangian_rounds=0)
        res = pipeline.run_pipeline(gfa_path, reads_path, out.name, opt,
                                    device=device)
        truth = _read_fasta_first_seq(truth_path)
        st = edit_stats(res.sequence, truth)
        return {"edit_distance": st.edit_distance,
                "recombinations": res.recombination_count,
                "time_s": round(time.time() - t0, 2)}
    finally:
        os.unlink(out.name)
