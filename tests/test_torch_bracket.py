"""Zero-length node chains and the bracket solve: the port against phi_tpu.

- The span fault: the sketch kernels pack a window's walk interval as
  (s << 6) | min(e - s, 63), so a k-mer that crosses a chain of empty nodes
  would get a clamped span on the device anchors. The port leaves them for
  the host hit path there, whose spans are exact: its occurrences equal
  the JAX package's host join on a graph with a 70-node chain.
- `solve_plain` against `phi_tpu.solve.dp._solve_jit` (bit-equal M, ends
  and sweeps) and `solve_dp_both` against the JAX package's (equal planes,
  sweeps and bound) on a frontier zerolen instance.
- `run_pipeline` on a small graph with an 80-node chain: a byte-identical
  FASTA, the bound and the path objective within 1e-4.
- The frontier zerolen family at chains 16, 70 and 120 over 3 seeds:
  records equal to `phi_tpu.eval.frontier`'s, bracket mode included.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from phi_tpu.config import Options as JaxOptions  # noqa: E402
from phi_tpu_torch.config import Options  # noqa: E402
from phi_tpu_torch.eval.synth import sample_reads, synth_pangenome  # noqa: E402
from phi_tpu_torch.io.build import build_gfa_data  # noqa: E402
from phi_tpu_torch.io.gfa import write_gfa  # noqa: E402
from phi_tpu_torch.pipeline import run_pipeline  # noqa: E402


def chain_site(gfa_data) -> int:
    """The first position from the middle of walk 0 whose vertex some but
    not all walks visit (a variant allele), each of them followed by the
    same vertex."""
    walks = [w.tolist() for w in gfa_data.walks]
    w0 = walks[0]
    for at in range(len(w0) // 2, len(w0) - 1):
        v = w0[at]
        nxt = {w[w.index(v) + 1] for w in walks if v in w}
        if len(nxt) == 1 and sum(v in w for w in walks) < len(walks):
            return at
    raise ValueError("no variant allele with one successor")


def with_chain(gfa_data, walks: list[int], at: int, n: int):
    """A copy of gfa_data with n empty segments z0..z{n-1} inserted after
    position `at` of walk walks[0], in every listed walk that visits that
    vertex. The walk sequences do not change."""
    segments = {name: gfa_data.node_seq(i)
                for i, name in enumerate(gfa_data.seg_names)}
    chain = [f"z{i}" for i in range(n)]
    for z in chain:
        segments[z] = ""
    names = gfa_data.seg_names
    v = int(gfa_data.walks[walks[0]][at])
    out = []
    for h, (wname, w) in enumerate(zip(gfa_data.walk_names, gfa_data.walks)):
        seq = [names[x] for x in w.tolist()]
        if h in walks and v in w.tolist():
            i = w.tolist().index(v) + 1
            seq = seq[:i] + chain + seq[i:]
        out.append((wname, seq))
    return build_gfa_data(segments, out)


def _chain_instance(d, chain: int, n_haps=4, length=1900, seed=5,
                    all_walks=False, breaks=None):
    """4 walks of ~1.9 kbp with `chain` empty segments after a node in the
    middle of walk 0 (with all_walks: after a variant allele, in every walk
    that visits it); 150 bp reads at 3x of walk 0, or of a mosaic switching
    at `breaks`."""
    rng = np.random.default_rng(seed)
    gfa_data, hap_seqs = synth_pangenome(rng, length=length, n_haps=n_haps)
    reads, _ = sample_reads(rng, hap_seqs if breaks else hap_seqs[:1],
                            coverage=3.0, read_len=150, error_rate=0.0,
                            recomb_breaks=breaks)
    if all_walks:
        g = with_chain(gfa_data, list(range(n_haps)), chain_site(gfa_data),
                       chain)
    else:
        g = with_chain(gfa_data, [0], len(gfa_data.walks[0]) // 2, chain)
    gfa_path, reads_path = str(d / "chain.gfa"), str(d / "reads.fa")
    write_gfa(g, path=gfa_path)
    with open(reads_path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    return gfa_path, reads_path


def _occurrences(anchors):
    anchors.materialize_device()
    return sorted(zip(anchors.occ_hap.tolist(), anchors.occ_start.tolist(),
                      anchors.occ_end.tolist(), anchors.occ_kmer.tolist()))


def test_zero_length_chain_spans_match_reference(tmp_path, capfd):
    """A k-mer across a 70-node chain spans more than 63 walk positions:
    the port's anchors equal the JAX package's host join (exact spans),
    and the device anchors say why they handed over."""
    from phi_tpu.pipeline import run_pipeline as jax_run
    gfa_path, reads_path = _chain_instance(tmp_path, 70)
    kw = dict(k=31, w=25, recombination=100)
    want = jax_run(gfa_path, reads_path, str(tmp_path / "jax.fa"),
                   JaxOptions(**kw))
    got = run_pipeline(gfa_path, reads_path, str(tmp_path / "port.fa"),
                       Options(**kw), device="cpu")
    a, b = _occurrences(got.anchors), _occurrences(want.anchors)
    assert max(e - s for _, s, e, _ in b) > 63
    diff = sorted(set(a) ^ set(b))
    assert a == b, f"occurrences (hap, start, end, kmer) differ: {diff}"
    assert "spans past 63 walk positions" in capfd.readouterr().err


def _zerolen_tables(seed: int, chain: int):
    """The frontier zerolen instance (phi_tpu/eval/frontier.py:case_zerolen)
    as each package's bracket-mode SolverTables, from one read spectrum."""
    from phi_tpu.anchors.join import build_anchor_tables as j_build
    from phi_tpu.anchors.join import sketch_haplotypes as j_sketch
    from phi_tpu.graph import tensorize as j_tensorize
    from phi_tpu.io.build import build_gfa_data as j_gfa
    from phi_tpu.solve import prep as jprep
    from phi_tpu_torch.anchors.join import (build_anchor_tables,
                                            sketch_haplotypes)
    from phi_tpu_torch.graph.pangenome import tensorize
    from phi_tpu_torch.io.gfa import encode_seq
    from phi_tpu_torch.io.reads import ReadBatch
    from phi_tpu_torch.pipeline import read_spectrum
    from phi_tpu_torch.solve import prep as tprep
    rng = random.Random(seed)
    seq = lambda n: "".join(rng.choice("ACGT") for _ in range(n))  # noqa: E731
    segments = {"L": seq(10), "Rr": seq(10)}
    ins = seq(6)
    chain_names = [f"z{i}" for i in range(chain)]
    for z in chain_names:
        segments[z] = ""
    segments["ins"] = ins
    walks = [("A.0", ["L"] + chain_names + ["Rr"]), ("B.0", ["L", "ins", "Rr"])]
    read = segments["L"] + segments["Rr"]
    k, w, R = 8, 2, 1.0
    spectrum = read_spectrum(ReadBatch(
        np.array([len(read)], np.int32), ["r"], concat=encode_seq(read),
        off=np.array([0, len(read)], np.int64)), k, w)
    g = tensorize(build_gfa_data(segments, walks))
    a = build_anchor_tables(g, k, sketch_haplotypes(g, k, w, device="cpu"),
                            spectrum, 1.0)
    t = tprep.build_solver_tables(g, a, R, tprep.solver_layers(g, k))
    jg = j_tensorize(j_gfa(segments, walks))
    ja = j_build(jg, k, j_sketch(jg, k, w), spectrum, 1.0)
    jt = jprep.build_solver_tables(jg, ja, R, jprep.solver_layers(jg, k))
    assert t.n_layers is None and jt.n_layers is None
    for name in ("S", "B", "esrc_h", "esrc_p", "esrc_target",
                 "state_vertex", "walk_len"):
        np.testing.assert_array_equal(getattr(t, name), getattr(jt, name),
                                      err_msg=name)
    assert t.const == jt.const
    return t, jt


@pytest.mark.parametrize("charge", ["S", "B"])
@pytest.mark.parametrize("chain", [70, 120])
def test_solve_plain_matches_solve_jit(chain, charge):
    """The plain sweep under the search (S) and the optimistic (B) charge:
    M, ends and the sweep count bit-equal to the JAX package's."""
    from phi_tpu.solve import dp as jdp
    from phi_tpu_torch import state
    from phi_tpu_torch.solve.dp import solve_plain
    t, _ = _zerolen_tables(4001, chain)
    S, B = state.credit_tensors(t, "cpu")
    eh, ep, et, sv, wl = state.solver_static(t, "cpu")
    M, ends, sweeps = solve_plain(S if charge == "S" else B, B, eh, ep, et,
                                  sv, wl, float(np.float32(t.R)), t.n_vtx, 256)
    jS = jnp.asarray(t.S if charge == "S" else t.B)
    jM, jends, jsweeps = jdp._solve_jit(
        jS, jnp.asarray(t.B), jnp.asarray(t.esrc_h), jnp.asarray(t.esrc_p),
        jnp.asarray(t.esrc_target), jnp.asarray(t.state_vertex),
        jnp.asarray(t.walk_len), jnp.float32(t.R), n_vtx=t.n_vtx,
        max_sweeps=256)
    np.testing.assert_array_equal(M.numpy(), np.asarray(jM))
    np.testing.assert_array_equal(ends.numpy(), np.asarray(jends))
    assert sweeps == int(jsweeps) >= 2


@pytest.mark.parametrize("chain", [70, 120])
def test_solve_dp_both_matches_jax(chain):
    from phi_tpu.solve import dp as jdp
    from phi_tpu_torch.solve.dp import LAST_TIMINGS, solve_dp_both
    t, jt = _zerolen_tables(4002, chain)
    LAST_TIMINGS["exec"] = 1.0
    (sol, ends), (sol_o, ends_o), sweeps, lb = solve_dp_both(t, 256, "cpu")
    (jM, jends), (jM_o, jends_o), jsweeps, jlb = jdp.solve_dp_both(jt, 256)
    np.testing.assert_array_equal(sol.M.numpy(), jM)
    np.testing.assert_array_equal(sol_o.M.numpy(), jM_o)
    np.testing.assert_array_equal(ends, jends)
    np.testing.assert_array_equal(ends_o, jends_o)
    assert (sweeps, lb) == (jsweeps, jlb)
    assert not LAST_TIMINGS
    assert sol.device.type == "cpu"


def test_pipeline_with_chain_matches_reference(tmp_path):
    """A 3-switch mosaic read set over 4 walks of 6 kbp, with an 80-node
    chain after a variant allele in every walk that visits it: the host hit
    path and the bracket solve, then the whole certification ladder (the
    optimistic bound leaves a gap here in both packages), give the JAX
    package's FASTA, bound and objective."""
    from phi_tpu.pipeline import run_pipeline as jax_run
    gfa_path, reads_path = _chain_instance(
        tmp_path, 80, length=6000, all_walks=True,
        breaks=[(1000, 1), (2000, 0), (4000, 2)])
    kw = dict(k=21, w=11, recombination=3)
    want = jax_run(gfa_path, reads_path, str(tmp_path / "jax.fa"),
                   JaxOptions(**kw))
    got = run_pipeline(gfa_path, reads_path, str(tmp_path / "port.fa"),
                       Options(**kw), device="cpu")
    a = got.anchors
    assert a.device_occ is None and int((a.occ_end - a.occ_start).max()) > 65
    with open(tmp_path / "jax.fa", "rb") as f1, \
            open(tmp_path / "port.fa", "rb") as f2:
        assert f1.read() == f2.read()
    assert got.report_segments == want.report_segments
    assert got.decode.dp_objective == pytest.approx(
        want.decode.dp_objective, abs=1e-4)
    assert got.decode.true_objective == pytest.approx(
        want.decode.true_objective, abs=1e-4)
    assert got.decode.solver_device == "cpu"
    assert got.decode.n_switches == want.decode.n_switches > 0


@pytest.mark.parametrize("seed", [4000, 4001, 4002])
@pytest.mark.parametrize("chain", [16, 70, 120])
def test_frontier_zerolen_matches_jax(chain, seed):
    import phi_tpu.eval.frontier as jf
    import phi_tpu_torch.eval.frontier as tf
    got = dataclasses.asdict(tf.case_zerolen(seed, chain, device="cpu"))
    want = dataclasses.asdict(jf.case_zerolen(seed, chain))
    assert got == want
    assert got["bracket_mode"] == (chain > 64)
