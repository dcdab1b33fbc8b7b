"""The port's panel subsetting (`phi_tpu_torch.io.subset`, `phi-torch-subset`)
against phi_tpu's on the CPU: on the 6 x 5 kbp graph of tests/test_subset.py,
each package's own generator from the same seed, `subset_panel` gives equal
GfaData field by field for several keep lists, `write_gfa` writes the same
bytes, and the CLI gives the same exit code and the same [M::] / [E::] line
for -n, --keep and its errors."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from phi_tpu.eval.synth import synth_pangenome as jax_synth  # noqa: E402
from phi_tpu.io.gfa import read_gfa as jax_read_gfa  # noqa: E402
from phi_tpu.io.gfa import write_gfa as jax_write_gfa  # noqa: E402
from phi_tpu.io.subset import main as jax_main  # noqa: E402
from phi_tpu.io.subset import subset_panel as jax_subset  # noqa: E402
from phi_tpu_torch.eval.synth import synth_pangenome  # noqa: E402
from phi_tpu_torch.io.gfa import read_gfa, write_gfa  # noqa: E402
from phi_tpu_torch.io.subset import main, subset_panel  # noqa: E402

KEEPS = [[0, 2, 5], [0], [4, 1], [5, 4, 3, 2, 1, 0], [3, 3]]


@pytest.fixture(scope="module")
def graphs():
    """(port GfaData, phi_tpu GfaData) of tests/test_subset.py's graph."""
    g, _ = synth_pangenome(np.random.default_rng(7), length=5_000, n_haps=6,
                           var_rate=0.02)
    jg, _ = jax_synth(np.random.default_rng(7), length=5_000, n_haps=6,
                      var_rate=0.02)
    return g, jg


def _assert_same_gfa(a, b) -> None:
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif f.name == "walks":
            assert len(x) == len(y)
            for u, v in zip(x, y):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("keep", KEEPS, ids=lambda k: "-".join(map(str, k)))
def test_subset_panel_matches_jax(graphs, keep):
    g, jg = graphs
    sub, jsub = subset_panel(g, keep), jax_subset(jg, keep)
    _assert_same_gfa(sub, jsub)
    assert write_gfa(sub) == jax_write_gfa(jsub)


def test_subset_panel_keeps_tags_and_meta(graphs, tmp_path):
    """A graph read back from a file carries S-line tags and W-line meta:
    both packages keep them for the kept segments and walks alike."""
    g, jg = graphs
    lines = write_gfa(g).splitlines()
    lines = [ln + "\tLN:i:%d" % len(ln.split("\t")[2]) if ln.startswith("S\t")
             else ln for ln in lines]
    lines = [ln.replace("\t_\t0\t", "\tchr6\t100\t", 1) if ln.startswith("W\t")
             else ln for ln in lines]
    p = tmp_path / "tagged.gfa"
    p.write_text("\n".join(lines) + "\n")
    t, jt = read_gfa(str(p)), jax_read_gfa(str(p))
    assert t.seg_tags and t.walk_meta
    sub, jsub = subset_panel(t, [1, 4]), jax_subset(jt, [1, 4])
    _assert_same_gfa(sub, jsub)
    assert write_gfa(sub) == jax_write_gfa(jsub)
    assert sub.walk_meta[0][0] == "chr6"


def test_subset_bad_index_raises_as_jax(graphs):
    g, jg = graphs
    with pytest.raises(ValueError) as a:
        subset_panel(g, [99])
    with pytest.raises(ValueError) as b:
        jax_subset(jg, [99])
    assert str(a.value) == str(b.value)


def _cli_args(graphs, tmp_path):
    g, _ = graphs
    src = tmp_path / "g.gfa"
    write_gfa(g, path=str(src))
    keep = ",".join(g.walk_names[i] for i in (4, 1))
    return src, [["-n", "3"], ["--keep", keep], ["--keep", "nope.0"],
                 ["-n", "0"], ["-n", "7"]]


def test_subset_cli_matches_jax(graphs, tmp_path, capsys):
    src, cases = _cli_args(graphs, tmp_path)
    for extra in cases:
        out, jout = tmp_path / "sub.gfa", tmp_path / "jsub.gfa"
        rc = main(["-g", str(src), "-o", str(out)] + extra)
        err = capsys.readouterr().err
        jrc = jax_main(["-g", str(src), "-o", str(jout)] + extra)
        jerr = capsys.readouterr().err
        assert rc == jrc, extra
        assert err.replace(str(out), "OUT") == jerr.replace(str(jout), "OUT")
        assert err.startswith("[M::main] kept" if rc == 0 else "[E::main]")
        if rc == 0:
            assert out.read_bytes() == jout.read_bytes()
