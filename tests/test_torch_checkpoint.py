"""--save-index and --load-index on the CPU: the port against phi_tpu.

- `--save-index`: byte-identical FASTA and report, and equal index arrays.
  Hits are compared in file order, not sorted: both packages write each
  haplotype's hits in position order (the native anchor tables check it),
  so any reordering would be a fault.
- `--load-index` at another -R: byte-identical FASTA and report, equal
  bound and objective; no reads are read.
- The port's `--save-index` FASTA equals its default (device-anchor)
  route's: the reference's contract that the hit path and the
  device-anchor path build the same tables.
- Indexes load across the packages; mismatched k/w or haplotype counts
  exit 1 with [E::main]; walks holding N and k > 31 take the host join as
  in phi_tpu, and `--mesh`, which the port has not taken over, raises and
  names itself.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from phi_tpu.checkpoint import load_index as jax_load  # noqa: E402
from phi_tpu.checkpoint import save_index as jax_save  # noqa: E402
from phi_tpu.config import Options as JaxOptions  # noqa: E402
from phi_tpu_torch import cli  # noqa: E402
from phi_tpu_torch.checkpoint import load_index, save_index  # noqa: E402
from phi_tpu_torch.config import Options  # noqa: E402
from phi_tpu_torch.eval.synth import sample_reads, synth_pangenome  # noqa: E402
from phi_tpu_torch.io.build import build_gfa_data  # noqa: E402
from phi_tpu_torch.io.gfa import write_gfa  # noqa: E402
from phi_tpu_torch.pipeline import run_pipeline  # noqa: E402


def _write(d, gfa_data, reads):
    gfa_path, reads_path = str(d / "graph.gfa"), str(d / "reads.fa")
    write_gfa(gfa_data, path=gfa_path)
    with open(reads_path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    return gfa_path, reads_path


def _mosaic(d):
    rng = np.random.default_rng(11)
    gfa_data, hap_seqs = synth_pangenome(rng, length=7000, n_haps=4,
                                         indel_fraction=0.1)
    reads, _ = sample_reads(rng, hap_seqs, coverage=3.0, read_len=120,
                            error_rate=0.002,
                            recomb_breaks=[(2300, 2), (4800, 3)])
    return _write(d, gfa_data, reads)


def _paralog(d):
    """Lane B repeats a motif the read carries once: duplicate k-mer credit
    opens the duality gap, so the Lagrangian rounds run on host tables."""
    rng = np.random.default_rng(1)
    motif = "ACGGTTCAAGGC"
    segments, A, B = {}, [], []

    def seg(seq):
        out = []
        for i in range(0, len(seq), 5):
            segments[f"s{len(segments)}"] = seq[i:i + 5]
            out.append(f"s{len(segments) - 1}")
        return out

    def rand(n):
        return "".join("ACGT"[c] for c in rng.integers(0, 4, n))

    shared = seg("TTACCGGATCAA")
    A += shared
    B += shared
    for _ in range(3):
        A += seg(rand(12))
        B += seg(motif + rand(1))
    shared = seg("GGTTACAGCATT")
    A += shared
    B += shared
    read = "".join(segments[s] for s in A) + motif
    return _write(d, build_gfa_data(segments, [("A.0", A), ("B.0", B)]),
                  [read])


# (instance, k, w, R of the saving run, R of the re-solve)
CASES = {"mosaic": (_mosaic, 31, 25, 5.0, 1.0),
         "paralog": (_paralog, 8, 3, 100.0, 30.0)}


@pytest.fixture
def jax_run(monkeypatch):
    """phi_tpu's run_pipeline with its device solve (as the port's
    pipeline tests run it); on the CPU its hit path joins natively."""
    monkeypatch.setenv("PHI_TPU_FORCE_DEVICE_SOLVE", "1")
    from phi_tpu.pipeline import run_pipeline as jax_run
    return jax_run


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _arrays(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("case", sorted(CASES))
def test_save_index_matches_jax(tmp_path, jax_run, case):
    build, k, w, R, _ = CASES[case]
    gfa_path, reads_path = build(tmp_path)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jidx, tidx = tmp_path / "jax" / "index.npz", tmp_path / "port" / "index.npz"
    want = jax_run(gfa_path, reads_path, str(tmp_path / "jax.fa"),
                   JaxOptions(k=k, w=w, recombination=R,
                              save_index=str(jidx)))
    got = run_pipeline(gfa_path, reads_path, str(tmp_path / "port.fa"),
                       Options(k=k, w=w, recombination=R,
                               save_index=str(tidx)), device="cpu")
    assert _read(tmp_path / "jax.fa") == _read(tmp_path / "port.fa")
    assert got.recombination_count == want.recombination_count
    assert got.report_segments == want.report_segments
    assert got.anchors.device_occ is None  # the hit path ran
    a, b = _arrays(jidx), _arrays(tidx)
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert sum(len(b[f"h{h}_pos"]) for h in range(int(b["n_haps"][0]))) > 0
    assert set(want.timings) <= set(got.timings) | {"solve_decode"}
    # the default route builds the same tables on the device
    default = run_pipeline(gfa_path, reads_path,
                           str(tmp_path / "default.fa"),
                           Options(k=k, w=w, recombination=R), device="cpu")
    assert default.anchors.device_occ is not None
    assert _read(tmp_path / "default.fa") == _read(tmp_path / "port.fa")


@pytest.mark.parametrize("case", sorted(CASES))
def test_load_index_matches_jax(tmp_path, jax_run, case):
    """Both packages re-solve one index (the port's) at another R, without
    reads: the FASTA record name comes from the index path."""
    build, k, w, R, R2 = CASES[case]
    gfa_path, reads_path = build(tmp_path)
    idx = str(tmp_path / "index.npz")
    run_pipeline(gfa_path, reads_path, None,
                 Options(k=k, w=w, recombination=R, save_index=idx),
                 device="cpu")
    want = jax_run(gfa_path, None, str(tmp_path / "jax.fa"),
                   JaxOptions(k=k, w=w, recombination=R2, load_index=idx))
    got = run_pipeline(gfa_path, None, str(tmp_path / "port.fa"),
                       Options(k=k, w=w, recombination=R2, load_index=idx),
                       device="cpu")
    assert _read(tmp_path / "jax.fa") == _read(tmp_path / "port.fa")
    assert got.recombination_count == want.recombination_count
    assert got.report_segments == want.report_segments
    assert got.decode.dp_objective == pytest.approx(
        want.decode.dp_objective, abs=1e-3)
    assert got.decode.true_objective == pytest.approx(
        want.decode.true_objective, abs=1e-3)
    assert got.timings["load_reads"] == got.timings["sketch_reads"] == 0.0
    assert got.anchors.n_model_kmers == want.anchors.n_model_kmers


def _random_index(seed):
    rng = np.random.default_rng(seed)
    sp_hi = rng.integers(0, 1 << 30, 50).astype(np.uint32)
    sp_lo = rng.integers(0, 1 << 32, 50).astype(np.uint32)
    hits = []
    for h in range(3):
        n = int(rng.integers(0, 20))
        hits.append((int(rng.integers(n, 100)),
                     np.sort(rng.integers(0, 10_000, n)).astype(np.int32),
                     rng.integers(0, 50, n).astype(np.int32)))
    return (sp_hi, sp_lo), hits


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_index_loads_in_the_other_package(tmp_path, writer):
    spectrum, hits = _random_index(3)
    meta = {"k": 21, "w": 11}
    path = str(tmp_path / "x")  # no suffix: both append .npz
    save, load = (save_index, jax_load) if writer == "port" else \
        (jax_save, load_index)
    save(path, spectrum, hits, meta=meta)
    sp2, hits2, meta2 = load(path)
    for a, b in zip(spectrum, sp2):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert len(hits2) == len(hits)
    for (n, p, s), (n2, p2, s2) in zip(hits, hits2):
        assert n == n2
        np.testing.assert_array_equal(p, p2)
        np.testing.assert_array_equal(s, s2)
    assert {k: int(v) for k, v in meta2.items()} == meta


@pytest.mark.parametrize("bad", ["k", "w", "haps"])
def test_load_index_mismatch_exits_1(tmp_path, capsys, bad):
    gfa_path, _ = _mosaic(tmp_path)
    spectrum, hits = _random_index(5)
    hits.append(hits[0])  # 4 haplotypes, as the graph
    meta = {"k": 31, "w": 25}
    if bad == "haps":
        hits = hits[:3]
    else:
        meta[bad] = 15
    idx = str(tmp_path / "index.npz")
    save_index(idx, spectrum, hits, meta=meta)
    out = tmp_path / "o.fa"
    rc = cli.main(["-g", gfa_path, "--load-index", idx, "-o", str(out),
                   "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 1
    assert "[E::main]" in err
    assert ("has 3 haplotypes, graph has 4" if bad == "haps"
            else "was built with") in err
    assert not out.exists()


def test_cli_needs_reads_or_index(tmp_path, capsys):
    gfa_path, _ = _mosaic(tmp_path)
    rc = cli.main(["-g", gfa_path, "-o", str(tmp_path / "o.fa"),
                   "--device", "cpu"])
    assert rc == 1
    assert "usage" in capsys.readouterr().err


def _n_walk(d):
    segments = {"a": "ACGTTGCAAGGCTTACGATC", "b": "GGATNNACGT",
                "c": "TTGACCAGTAGGCATTACGA"}
    return _write(d, build_gfa_data(segments, [("x.0", ["a", "b", "c"]),
                                               ("y.0", ["a", "c"])]),
                  ["ACGTTGCAAGGCTTACGATCTTGACCAGTAGGCATTACGA"])


@pytest.mark.parametrize("refusal,opt", [
    (None, dict(k=5, w=3)),
    (None, dict(k=35, w=25)),
    ("--mesh", dict(k=5, w=3, mesh_devices=2)),
], ids=["n_walk", "wide_k", "mesh"])
def test_save_index_refusals_name_their_condition(tmp_path, jax_run,
                                                  refusal, opt):
    """A walk holding N and k > 31 take the host join on `--save-index`, as
    in phi_tpu: the same FASTA and index arrays. `--mesh` stays a
    refusal."""
    gfa_path, reads_path = (_n_walk(tmp_path) if opt["k"] == 5
                            else _mosaic(tmp_path))
    idx = tmp_path / "i.npz"
    if refusal:
        with pytest.raises(NotImplementedError, match=refusal):
            run_pipeline(gfa_path, reads_path, None,
                         Options(save_index=str(idx), **opt), device="cpu")
        assert not idx.exists()
        return
    jidx = tmp_path / "j.npz"
    want = jax_run(gfa_path, reads_path, str(tmp_path / "jax.fa"),
                   JaxOptions(save_index=str(jidx), **opt))
    got = run_pipeline(gfa_path, reads_path, str(tmp_path / "port.fa"),
                       Options(save_index=str(idx), **opt), device="cpu")
    assert _read(tmp_path / "jax.fa") == _read(tmp_path / "port.fa")
    assert got.report_segments == want.report_segments
    a, b = _arrays(jidx), _arrays(idx)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
