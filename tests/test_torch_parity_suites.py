"""The JAX package's edge-case suites through both run_pipelines on the CPU
(phi_tpu on its default route, the port on CPU tensors), one case per
input: the FASTA byte for byte, the recombination count and report, both
objectives (within 1e-3) and the certified flag; where the instance is
small enough, the port's bound and primal value bracket the optimum of
the port's brute-force oracle (solve/exact.py:brute_force_optimum).

The inputs are those of tests/test_edge_cases.py (a linear single walk,
reads that match nothing, a read shorter than a window),
test_report_format.py (its toy graph, the boundary quirk and the double
switch), test_optimality_stress.py (seeds 10-21 with their drawn k, w, R,
T), test_long_reads.py (mixed lengths), test_crlf.py, test_link_folding.py,
test_synth_recomb.py, test_synth_indels.py and test_k_large.py
(the wide-k pipeline; k > 63 refused)."""

import random

import numpy as np
import pytest

pytest.importorskip("jax")

from phi_tpu.config import Options as JaxOptions  # noqa: E402
from phi_tpu.eval.synth import sample_reads, synth_pangenome  # noqa: E402
from phi_tpu.io.build import build_gfa_data  # noqa: E402
from phi_tpu.io.gfa import write_gfa  # noqa: E402
from phi_tpu.pipeline import run_pipeline as jax_run  # noqa: E402
from phi_tpu_torch import native  # noqa: E402
from phi_tpu_torch.config import Options  # noqa: E402
from phi_tpu_torch.pipeline import gap_tol, run_pipeline  # noqa: E402
from phi_tpu_torch.solve.exact import brute_force_optimum  # noqa: E402
from phi_tpu_torch.solve.prep import build_solver_tables  # noqa: E402


def _fasta(reads) -> bytes:
    return "".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)).encode()


def _case(tmp_path, gfa, reads, **kw):
    """Write the graph (GfaData or GFA text) and reads (a list, or the
    bytes of a reads file); returns (gfa path, reads path, options)."""
    gfa_path = tmp_path / "graph.gfa"
    if isinstance(gfa, (str, bytes)):
        gfa_path.write_bytes(gfa if isinstance(gfa, bytes) else gfa.encode())
    else:
        write_gfa(gfa, path=str(gfa_path))
    reads_path = tmp_path / kw.pop("reads_name", "reads.fa")
    reads_path.write_bytes(reads if isinstance(reads, bytes)
                           else _fasta(reads))
    return str(gfa_path), str(reads_path), kw


def _both(tmp_path, gfa, reads, brute=False, **kw):
    """Both packages on one input; returns the port's result."""
    gfa_path, reads_path, kw = _case(tmp_path, gfa, reads, **kw)
    want = jax_run(gfa_path, reads_path, str(tmp_path / "jax.fa"),
                   JaxOptions(**kw))
    opt = Options(**kw)
    got = run_pipeline(gfa_path, reads_path, str(tmp_path / "port.fa"), opt,
                       device="cpu")
    assert (tmp_path / "port.fa").read_bytes() == \
        (tmp_path / "jax.fa").read_bytes()
    assert got.sequence == want.sequence
    assert got.recombination_count == want.recombination_count
    assert got.report_segments == want.report_segments
    assert got.decode.dp_objective == pytest.approx(
        want.decode.dp_objective, abs=1e-3)
    assert got.decode.true_objective == pytest.approx(
        want.decode.true_objective, abs=1e-3)
    tol = gap_tol(opt.recombination)
    assert (got.decode.true_objective - got.decode.dp_objective <= tol) == \
        (want.decode.true_objective - want.decode.dp_objective <= tol)
    if brute:
        tables = build_solver_tables(got.graph, got.anchors,
                                     opt.recombination)
        exact, _ = brute_force_optimum(got.graph, tables, got.anchors)
        assert got.decode.true_objective >= exact - 1e-3
        assert got.decode.dp_objective <= exact + 1e-3
    return got


# --- tests/test_edge_cases.py ---

LINEAR = "ACGTTGCACAGTCAGGTACCATGGACTT"
TWO_WALKS = ({"a": "ACGTTGCA", "x": "TACCA", "y": "AGGAT", "z": "TGCATGCA"},
             [("h1.0", ["a", "x", "z"]), ("h2.0", ["a", "y", "z"])])


@pytest.mark.parametrize("name", ["linear_single_walk", "no_matching_reads",
                                  "read_shorter_than_window"])
def test_edge_cases(tmp_path, name):
    kw = dict(k=5, w=3, recombination=10.0)
    if name == "linear_single_walk":
        got = _both(tmp_path, build_gfa_data({"s1": LINEAR},
                                             [("ref.0", ["s1"])]),
                    [LINEAR[3:20]], brute=True, **kw)
        assert got.sequence == LINEAR and got.recombination_count == 0
    elif name == "no_matching_reads":
        got = _both(tmp_path, build_gfa_data(*TWO_WALKS), ["C" * 20],
                    brute=True, **kw)
        assert got.sequence in ("ACGTTGCATACCATGCATGCA",
                                "ACGTTGCAAGGATTGCATGCA")
        assert got.recombination_count == 0
    else:
        got = _both(tmp_path, build_gfa_data(
            {"a": "ACGTTGCA", "z": "TGCATGCA"}, [("h.0", ["a", "z"])]),
            ["ACG"], brute=True, **kw)
        assert got.sequence == "ACGTTGCATGCATGCA"


# --- tests/test_report_format.py ---

def _bubble_chain(n_bubbles: int, seed: int):
    """Two walks through a chain of n_bubbles bubbles (16 bp alleles
    between 12 bp shared nodes) and their allele names."""
    rng = random.Random(seed)

    def rand(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    segments, walks = {"s0": rand(12)}, [["s0"], ["s0"]]
    for b in range(n_bubbles):
        for h in range(2):
            segments[f"v{b}_{h}"] = rand(16)
            walks[h].append(f"v{b}_{h}")
        segments[f"s{b + 1}"] = rand(12)
        for h in range(2):
            walks[h].append(f"s{b + 1}")
    return segments, walks


@pytest.mark.parametrize("name,choice", [
    ("toy_one_segment", None), ("single_switch", (0, 1, 1)),
    ("double_switch", (0, 1, 0)), ("switch_at_the_last_bubble", (0, 0, 1))])
def test_report_format(tmp_path, name, choice):
    """The report toy through both pipelines, and reads that follow walk 0
    or 1 at each of three bubbles: the same report segments, including the
    reference's boundary arithmetic."""
    if choice is None:
        gfa = build_gfa_data({"a": "AAAA", "b": "CCC", "c": "GG",
                              "d": "TTTTT"},
                             [("h1.0", list("abcd")), ("h2.0", list("abcd"))])
        got = _both(tmp_path, gfa, ["AAAACCCGGTTTTT"], brute=True, k=3, w=1,
                    recombination=10.0)
        assert got.report_segments == [">(h1.0,[0,13])"]
        return
    segments, walks = _bubble_chain(3, seed=7)
    path = [walks[0][0]]
    for b, h in enumerate(choice):
        path += [f"v{b}_{h}", f"s{b + 1}"]
    read = "".join(segments[s] for s in path)
    got = _both(tmp_path, build_gfa_data(segments, [("h1.0", walks[0]),
                                                    ("h2.0", walks[1])]),
                [read], brute=True, k=7, w=3, recombination=0.25)
    switches = sum(a != b for a, b in zip(choice, choice[1:]))
    assert got.recombination_count == switches
    assert got.sequence == read


@pytest.mark.parametrize("hap,want", [
    ([0, 0, 0, 0], (0, [">(h1.0,[0,13])"])),
    ([0, 0, 1, 1], (1, [">(h1.0,[0,8])", ">(h2.0,[9,13])"])),
    ([0, 1, 1, 0], (2, [">(h1.0,[0,6])", ">(h2.0,[7,13])",
                        ">(h1.0,[14,13])"]))],
    ids=["one_segment", "boundary_quirk", "double_switch"])
def test_report_arithmetic_matches_jax(hap, want):
    """test_report_format.py's vertex and hap arrays through both
    packages' recombination_report."""
    from phi_tpu.emit import recombination_report as jax_report
    from phi_tpu.graph import tensorize as jax_tensorize
    from phi_tpu_torch.emit import recombination_report
    from phi_tpu_torch.graph.pangenome import tensorize
    from phi_tpu_torch.io.build import build_gfa_data as port_build
    segs = {"a": "AAAA", "b": "CCC", "c": "GG", "d": "TTTTT"}
    walks = [("h1.0", list("abcd")), ("h2.0", list("abcd"))]
    vertices = np.array([0, 1, 2, 3], np.int32)
    hap = np.array(hap, np.int32)
    got = recombination_report(tensorize(port_build(segs, walks)), vertices,
                               hap)
    assert tuple(got) == want
    assert tuple(jax_report(jax_tensorize(build_gfa_data(segs, walks)),
                            vertices, hap)) == want


# --- tests/test_optimality_stress.py ---

def _stress_instance(seed):
    """test_optimality_stress.py::_instance: a random bubble chain and one
    mosaic read."""
    rng = random.Random(seed)
    bases = "ACGT"
    n_blocks = rng.randint(3, 5)
    n_haps = rng.randint(2, 4)
    segments = {}
    walks_segs = [[] for _ in range(n_haps)]
    for b in range(n_blocks):
        segments[f"a{b}"] = "".join(rng.choice(bases)
                                    for _ in range(rng.randint(4, 7)))
        for h in range(n_haps):
            walks_segs[h].append(f"a{b}")
        if b < n_blocks - 1:
            n_alleles = rng.randint(1, 3)
            alleles = []
            for a in range(n_alleles):
                name = f"v{b}_{a}"
                segments[name] = "".join(rng.choice(bases)
                                         for _ in range(rng.randint(2, 6)))
                alleles.append(name)
            for h in range(n_haps):
                walks_segs[h].append(alleles[rng.randrange(n_alleles)])
    walks = [(f"hap{h}.0", walks_segs[h]) for h in range(n_haps)]
    h = rng.randrange(n_haps)
    read = ""
    for b in range(len(walks_segs[h])):
        if rng.random() < 0.35:
            h = rng.randrange(n_haps)
        read += segments[walks_segs[h][b]]
    return build_gfa_data(segments, walks), read


@pytest.mark.parametrize("seed", range(10, 22))
def test_optimality_stress(tmp_path, seed):
    gfa, read = _stress_instance(seed)
    rng = random.Random(seed)
    k = rng.choice([3, 4, 5])
    w = rng.choice([1, 2, 3])
    R = rng.choice([0.25, 1.0, 5.0])
    T = rng.choice([0.9, 1.0])
    _both(tmp_path, gfa, [read], brute=True, k=k, w=w, recombination=R,
          threshold=T, lagrangian_rounds=8)


# --- tests/test_long_reads.py ---

def test_mixed_length_reads(tmp_path):
    rng = random.Random(31)
    gfa, haps = synth_pangenome(np.random.default_rng(31), length=12_000,
                                n_haps=3)
    hap = haps[1]

    def sub(n):
        s = rng.randrange(0, len(hap) - n)
        return hap[s:s + n]

    reads = ([sub(rng.randint(60, 140)) for _ in range(40)]
             + [sub(rng.randint(3000, 5000)) for _ in range(3)])
    got = _both(tmp_path, gfa, reads, k=15, w=9, recombination=100.0)
    assert got.sequence == hap


# --- tests/test_crlf.py ---

CRLF_GFA = (b"H\tVN:Z:1.1\n"
            b"S\t1\tACGTACGTAA\n"
            b"S\t2\tTTGGCCAATT\n"
            b"L\t1\t+\t2\t+\t0M\n"
            b"W\tsampleA\t0\tchr1\t0\t20\t>1>2\n")
CRLF_READS = {
    "fastq": b"@r1 desc\nACGTACGTAA\n+\nIIIIIIIIII\n@r2\nTTGGCCAATT\n+\n"
             b"IIIIIIIIII\n",
    "fasta": b">r1 desc\nACGTACGTAA\nTTGG\n>r2\nCCAATT\n"}


@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
@pytest.mark.parametrize("eol", ["unix", "crlf"])
def test_crlf(tmp_path, fmt, eol):
    def conv(b):
        return b.replace(b"\n", b"\r\n") if eol == "crlf" else b

    got = _both(tmp_path, conv(CRLF_GFA), conv(CRLF_READS[fmt]), brute=True,
                reads_name=f"reads.{'fq' if fmt == 'fastq' else 'fa'}",
                k=5, w=3, recombination=10.0)
    assert got.sequence == "ACGTACGTAATTGGCCAATT"
    assert not (tmp_path / "port.fa").read_bytes().count(b"\r")


# --- tests/test_link_folding.py ---

LINK_SEGS = "S\ta\tACGTTGCAAC\nS\tb\tTTGGCCAATC\nS\tc\tGGATCCATGA\n"
LINK_WALKS = ("W\ts\t0\tchr\t0\t30\t>a>b>c\n"
              "W\tt\t0\tchr\t0\t20\t>a>c\n")
LINKS = {
    # every spelling folds to the edges a->b, b->c, a->c
    "plus_plus": "L\ta\t+\tb\t+\t0M\nL\tb\t+\tc\t+\t0M\nL\ta\t+\tc\t+\t0M\n",
    "minus_minus": "L\tb\t-\ta\t-\t0M\nL\tc\t-\tb\t-\t0M\nL\ta\t+\tc\t+\t0M\n",
    "minus_plus_adds_nothing": ("L\ta\t+\tb\t+\t0M\nL\tb\t+\tc\t+\t0M\n"
                                "L\ta\t+\tc\t+\t0M\nL\tc\t-\ta\t+\t0M\n"),
}


@pytest.mark.parametrize("spelling", sorted(LINKS))
def test_link_folding(tmp_path, spelling):
    got = _both(tmp_path, LINK_SEGS + LINKS[spelling] + LINK_WALKS,
                ["ACGTTGCAACTTGGCCAATCGGATCCATGA"], brute=True, k=5, w=3,
                recombination=1.0)
    assert got.sequence == "ACGTTGCAACTTGGCCAATCGGATCCATGA"
    assert sorted(zip(got.graph.gfa.edge_u.tolist(),
                      got.graph.gfa.edge_v.tolist())) == [(0, 1), (0, 2),
                                                           (1, 2)]


def test_link_folding_plus_minus_is_a_cycle(tmp_path):
    """L a + b - folds to a->b and b->a: both packages refuse the graph
    with the same error."""
    gfa_path, reads_path, _ = _case(
        tmp_path, LINK_SEGS + "L\ta\t+\tb\t-\t0M\nL\tb\t+\tc\t+\t0M\n"
        "L\ta\t+\tc\t+\t0M\n" + LINK_WALKS, ["ACGTTGCAAC"])
    with pytest.raises(ValueError) as want:
        jax_run(gfa_path, reads_path, str(tmp_path / "j.fa"),
                JaxOptions(k=5, w=3))
    with pytest.raises(ValueError) as got:
        run_pipeline(gfa_path, reads_path, str(tmp_path / "p.fa"),
                     Options(k=5, w=3), device="cpu")
    assert str(got.value) == str(want.value)
    assert "cycle" in str(got.value)


# --- tests/test_synth_recomb.py, test_synth_indels.py ---

@pytest.mark.parametrize("name", ["recomb", "indels"])
def test_synth_recombinant(tmp_path, name):
    if name == "recomb":
        rng = np.random.default_rng(11)
        gfa, haps = synth_pangenome(rng, length=20_000, n_haps=6,
                                    var_rate=0.01)
        target = haps[2][:8000] + haps[5][8000:]
        reads, _ = sample_reads(rng, [target], coverage=4.0, read_len=150,
                                error_rate=0.0)
        limit = 0
    else:
        rng = np.random.default_rng(19)
        gfa, haps = synth_pangenome(rng, length=25_000, n_haps=5,
                                    var_rate=0.012, indel_fraction=0.3)
        target = haps[1][:12_000] + haps[4][12_000:]
        reads, _ = sample_reads(rng, [target], coverage=4.0, read_len=150,
                                error_rate=0.001)
        limit = 20
    got = _both(tmp_path, gfa, reads, k=19, w=11, recombination=20.0)
    assert native.edit_distance(got.sequence, target) <= limit
    assert got.recombination_count >= 1


# --- tests/test_k_large.py ---

def test_wide_k_pipeline(tmp_path):
    rng = np.random.default_rng(4)
    gfa, haps = synth_pangenome(rng, length=8000, n_haps=4)
    reads, _ = sample_reads(rng, [haps[1]], coverage=3.0, read_len=150,
                            error_rate=0.0)
    got = _both(tmp_path, gfa, reads, k=35, w=11)
    assert got.sequence == haps[1]
    assert got.decode.true_objective - got.decode.dp_objective <= 0.5


@pytest.mark.parametrize("k", [64, 70])
def test_k_over_63_rejected(k):
    with pytest.raises(ValueError) as want:
        JaxOptions(k=k)
    with pytest.raises(ValueError) as got:
        Options(k=k)
    assert str(got.value) == str(want.value)
