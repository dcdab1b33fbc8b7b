"""The port's baselines and leave-one-out cross-validation against phi_tpu's
on the CPU:

- `best_panel_hap` on the two-walk toy of tests/test_baselines.py, on a
  5 x 20 kbp synthetic panel at k = 31 (the seq kernel's twin) and k = 35
  (the native scan), and on tied walks (the first of the largest counts);
- `run_best_hap_baseline` and `run_greedy_baseline` (R = 1e-3, no
  Lagrangian rounds) on that toy and on a 4 x 20 kbp mosaic instance:
  every field but the time;
- `leave_one_out` on the 3 x 8 kbp toy of tests/test_crossval.py: every
  field of every row but the wall; and the fold's baseline spectrum, the
  native scan's in the port, equal to phi_tpu's `sketch_read_batch` (its
  device read sketch on a padded batch) at k = 31 on every fold's reads;
- the crossval CLI's JSON lines, and its exit 1 with [E::main] on cuda
  without a card.
"""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from phi_tpu.eval import baselines as jbase  # noqa: E402
from phi_tpu.eval import crossval as jcv  # noqa: E402
from phi_tpu.graph import tensorize as jax_tensorize  # noqa: E402
from phi_tpu.io.build import build_gfa_data as jax_build  # noqa: E402
from phi_tpu.io.gfa import encode_seq as jax_encode  # noqa: E402
from phi_tpu.sketch.minimizer import sketch_read_batch  # noqa: E402
from phi_tpu_torch.eval import baselines, crossval  # noqa: E402
from phi_tpu_torch.eval.synth import sample_reads, synth_pangenome  # noqa: E402
from phi_tpu_torch.graph.pangenome import tensorize  # noqa: E402
from phi_tpu_torch.io.build import build_gfa_data  # noqa: E402
from phi_tpu_torch.io.gfa import read_gfa, write_gfa  # noqa: E402

SEGMENTS = {
    "X": "ACGTTGCAGGTTAACC", "A1": "TACCATTGAC", "B1": "AGGATCCTGA",
    "Y": "CAGTCAGTAACCGGTT", "A2": "CTTCCAGGTA", "B2": "GAACTTGCAC",
    "Z": "TGCATGCAATTGGCCA",
}
WALKS = [("hapA.0", ["X", "A1", "Y", "A2", "Z"]),
         ("hapB.0", ["X", "B1", "Y", "B2", "Z"])]


def _toy_files(tmp_path):
    """tests/test_baselines.py's instance: two walks, reads of hapA."""
    gfa = tmp_path / "toy.gfa"
    write_gfa(build_gfa_data(SEGMENTS, WALKS), path=str(gfa))
    hap_a = "".join(SEGMENTS[s] for s in WALKS[0][1])
    reads = tmp_path / "reads.fa"
    reads.write_text("".join(f">r{i}\n{hap_a[i * 8:i * 8 + 24]}\n"
                             for i in range(5)))
    truth = tmp_path / "truth.fa"
    truth.write_text(f">truth\n{hap_a}\n")
    return str(gfa), str(reads), str(truth)


@pytest.fixture(scope="module")
def mosaic(tmp_path_factory):
    """A 4 x 20 kbp mosaic instance (both packages' generator)."""
    from phi_tpu_torch.eval import scale
    d = tmp_path_factory.mktemp("mosaic")
    old = scale.CACHE_DIR
    scale.CACHE_DIR = str(d)
    try:
        p = scale.build_instance(4, 20_000, coverage=2.0, seed=5, n_breaks=2)
    finally:
        scale.CACHE_DIR = old
    return p["gfa"], p["reads"], p["truth"]


def _padded(reads):
    codes = np.full((len(reads), max(map(len, reads))), 4, np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = jax_encode(r)
        lengths[i] = len(r)
    return codes, lengths


def _panel(n_haps=5, seed=2):
    rng = np.random.default_rng(seed)
    gd, seqs = synth_pangenome(rng, length=20_000, n_haps=n_haps)
    reads, _ = sample_reads(rng, seqs[3:4], coverage=1.0, read_len=150,
                            error_rate=0.002)
    return gd, reads


@pytest.mark.parametrize("k,w", [(31, 25), (35, 25), (15, 10)])
def test_best_panel_hap_matches_jax(k, w):
    gd, reads = _panel()
    spectrum = crossval.fold_spectrum(reads, k, w)
    h, seq = baselines.best_panel_hap(tensorize(gd), spectrum, k, w, "cpu")
    jh, jseq = jbase.best_panel_hap(jax_tensorize(gd), spectrum, k, w)
    assert (h, seq) == (jh, jseq)
    assert h == 3


def test_best_panel_hap_toy_and_ties_match_jax():
    hap_a = "".join(SEGMENTS[s] for s in WALKS[0][1])
    reads = [hap_a[i * 8:i * 8 + 24] for i in range(5)]
    spectrum = crossval.fold_spectrum(reads, 5, 3)
    # three walks: B, A and A again; A's first copy wins the tie
    walks = [WALKS[1], WALKS[0], ("hapC.0", WALKS[0][1])]
    gd = build_gfa_data(SEGMENTS, walks)
    got = baselines.best_panel_hap(tensorize(gd), spectrum, 5, 3, "cpu")
    want = jbase.best_panel_hap(jax_tensorize(jax_build(SEGMENTS, walks)),
                                spectrum, 5, 3)
    assert got == want == (1, hap_a)


def _no_time(d: dict) -> dict:
    assert d["time_s"] >= 0
    return {k: v for k, v in d.items() if k != "time_s"}


@pytest.mark.parametrize("which", ["toy", "mosaic"])
def test_baseline_runners_match_jax(tmp_path, mosaic, which):
    if which == "toy":
        files, kw = _toy_files(tmp_path), {"k": 5, "w": 3}
    else:
        files, kw = mosaic, {"k": 15, "w": 5}
    got = baselines.run_best_hap_baseline(*files, **kw, device="cpu")
    assert _no_time(got) == _no_time(jbase.run_best_hap_baseline(*files, **kw))
    got = baselines.run_greedy_baseline(*files, **kw, device="cpu")
    assert _no_time(got) == _no_time(jbase.run_greedy_baseline(*files, **kw))
    if which == "toy":
        assert got["edit_distance"] == 0


@pytest.fixture(scope="module")
def toy_panel(tmp_path_factory):
    """tests/test_crossval.py's 3 x 8 kbp toy panel."""
    rng = np.random.default_rng(3)
    g, _ = synth_pangenome(rng, length=8000, n_haps=3)
    p = str(tmp_path_factory.mktemp("loo") / "toy.gfa")
    write_gfa(g, path=p)
    return p


@pytest.fixture(scope="module")
def loo_rows(toy_panel):
    kw = dict(coverage=3.0, error_rate=0.001, seed=7)
    return (crossval.leave_one_out(toy_panel, **kw, device="cpu"),
            jcv.leave_one_out(toy_panel, **kw))


def test_leave_one_out_matches_jax(loo_rows):
    port, ref = loo_rows
    assert len(port) == len(ref) == 3
    for a, b in zip(port, ref):
        assert set(a) == set(b)
        assert {k: v for k, v in a.items() if k != "wall_s"} == \
            {k: v for k, v in b.items() if k != "wall_s"}
        assert a["best_hap"] != a["target"] and a["gap"] >= 0.0


def test_fold_spectrum_equals_sketch_read_batch(toy_panel):
    """Each fold's reads, as leave_one_out samples them: the native scan's
    spectrum equals phi_tpu's device read sketch on the padded batch."""
    g = tensorize(read_gfa(toy_panel))
    for h in range(g.num_walks):
        truth = g.path_seq(g.walk_mat[h, :g.walk_len[h]])
        reads, _ = sample_reads(np.random.default_rng(7 + h), [truth],
                                coverage=3.0, read_len=150,
                                error_rate=0.001)
        got = crossval.fold_spectrum(reads, 31, 25)
        codes, lengths = _padded(reads)
        want = sketch_read_batch(codes, 31, 25, lengths)
        assert len(got[0]) > 0
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("cov", ["2.0", "1.0,2.0"], ids=["one", "grid"])
def test_crossval_cli_json_matches_jax(toy_panel, capsys, cov):
    """One coverage and one run: leave_one_out; a grid: leave_one_out_grid
    (the same keys plus the per-row wall summary)."""
    g = tensorize(read_gfa(toy_panel))
    args = ["-g", toy_panel, "-c", cov, "--runs", "1", "--seed", "1",
            "--targets", g.walk_names[1]]
    assert crossval.main(args + ["--device", "cpu"]) == 0
    port = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert jcv.main(args) == 0
    ref = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(port) == len(ref) == len(cov.split(","))
    wall = {"wall_s", "wall_median_s", "wall_iqr_s"}
    for a, b in zip(port, ref):
        assert list(a) == list(b)
        assert {k: v for k, v in a.items() if k not in wall} == \
            {k: v for k, v in b.items() if k not in wall}
        assert a["target"] == g.walk_names[1]


def test_crossval_cli_cuda_without_card_exits_1(toy_panel, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert crossval.main(["-g", toy_panel, "--runs", "1"]) == 1
    assert "[E::main]" in capsys.readouterr().err
