"""The benchmark's arithmetic on hand-made inputs: the generator's
determinism, nearest-rank p95, merged_us, the roofline byte count, the
module guard."""

import gzip
import os

import numpy as np
import pytest

from phibench import devtrace, guard, readers, synth
from phibench.harness import load_module

TRAFFIC = {"coverage": 1.0, "read_len": 150, "error_rate": 0.003,
           "private_rate": 5e-4, "n_rate": 0.002, "reverse_share": 0.5,
           "switches": [1, 4]}


def test_panel_is_determined_by_its_seed():
    a = synth.make_panel(7, 20000, 5, 0.01, 0.05, 30)
    b = synth.make_panel(7, 20000, 5, 0.01, 0.05, 30)
    c = synth.make_panel(8, 20000, 5, 0.01, 0.05, 30)
    assert np.array_equal(a.node_codes, b.node_codes)
    assert all(np.array_equal(x, y) for x, y in zip(a.walks, b.walks))
    assert not np.array_equal(a.node_codes[:1000], c.node_codes[:1000])
    assert a.node_len.max() <= 30


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3])
def test_samples_are_determined_by_seed_stream_and_index(seed):
    p = synth.make_panel(1, 20000, 5, 0.01, 0.05, 30)
    s1 = synth.make_sample(p, seed, 1, 0, TRAFFIC)
    s2 = synth.make_sample(p, seed, 1, 0, TRAFFIC)
    s3 = synth.make_sample(p, seed, 1, 1, TRAFFIC)
    assert np.array_equal(s1.reads, s2.reads) and s1.breaks == s2.breaks
    assert not np.array_equal(s1.reads, s3.reads)
    assert s1.reads.shape[1] == 150 and 1 <= len(s1.breaks) <= 4


def test_samples_carry_n_errors_and_both_strands():
    p = synth.make_panel(1, 200000, 5, 0.01, 0.05, 30)
    s = synth.make_sample(p, 2**31 + 7, 1, 0, TRAFFIC)
    assert 0.001 < (s.reads == 4).mean() < 0.003
    clean = dict(TRAFFIC, n_rate=0.0, reverse_share=0.0, error_rate=0.0)
    f = synth.make_sample(p, 5, 1, 0, clean)
    r = synth.make_sample(p, 5, 1, 0, dict(clean, reverse_share=1.0))
    # the same draws, each read taken from the other strand
    assert np.array_equal(r.reads, 3 - f.reads[:, ::-1])


def test_fastq_round_trip(tmp_path):
    p = synth.make_panel(1, 20000, 5, 0.01, 0.05, 30)
    s = synth.make_sample(p, 3, 1, 0, TRAFFIC)
    path = str(tmp_path / "r.fq.gz")
    synth.write_fastq(s.reads, path)
    with gzip.open(path, "rb") as f:
        lines = f.read().split(b"\n")
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    codes = np.stack([lut[np.frombuffer(x, np.uint8)] for x in lines[1::4]])
    assert np.array_equal(codes, s.reads) and (codes == 4).any()
    assert set(np.unique(np.frombuffer(b"".join(lines[1::4]), np.uint8))
               ) == set(b"ACGTN")
    assert set(lines[3::4]) == {b"I" * 150}


@pytest.mark.parametrize("values,q,want", [
    ([5.0], 95, 5.0), (list(range(1, 21)), 95, 19), (list(range(1, 11)), 95,
                                                        10),
    ([3.0, 1.0, 2.0], 50, 2.0), ([], 95, None)])
def test_nearest_rank(values, q, want):
    assert readers.nearest_rank(values, q) == want


def test_merged_us_counts_overlaps_once():
    assert devtrace.merged_us([(0, 10), (5, 15), (20, 25)]) == 20
    assert devtrace.merged_us([]) == 0
    assert devtrace.merge([(5, 15), (0, 10), (20, 25)]) == [(0, 15),
                                                            (20, 25)]


def test_reduce_clips_to_items_and_labels_gaps_by_phase():
    events = [("k", 100.0, 200.0), ("k", 150.0, 300.0), ("x", 5000.0, 6000.0)]
    ranges = {0: (0.0, 1000.0)}
    timings = {0: {"load_graph": 0.0001, "sketch_haps": 0.0005}}
    red = devtrace.reduce(events, ranges, timings)
    assert red["busy_us"] == 200 and red["window_us"] == 1000
    assert red["ops"] == {"k": 250.0}
    gaps = dict()
    for name, us in red["gaps"]:
        gaps[name] = gaps.get(name, 0) + us
    assert gaps == {"load_graph": 100.0, "sketch_haps": 300.0, "other": 400.0}


def test_roofline_byte_count():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    m = load_module(os.path.join(here, "metrics", "rows_roofline.py"),
                    "roof")
    # 4 bases a byte, 8 bytes a spectrum key, 8 bytes a retained hit
    assert m.join_bytes(4000, 10, 3) == 1000 + 80 + 24
    assert m.kernel_names() == ["tiled_kernel"]


@pytest.mark.parametrize("names,bad", [
    (["phi_tpu_torch", "phi_tpu_torch.cli", "numpy"], []),
    (["phi_tpu.x"], ["phi_tpu.x"]), (["jax.numpy"], ["jax.numpy"]),
    (["jaxlib", "flax.linen", "jaxtyping"], ["flax.linen", "jaxlib"])])
def test_module_guard(names, bad):
    assert guard.forbidden(names) == bad


def _brute_spectrum(reads, k, w):
    """The read spectrum by its definition, one window at a time."""
    keys = set()
    for r in reads.tolist():
        kms = []
        for i in range(len(r) - k + 1):
            km = r[i:i + k]
            if 4 in km:
                kms.append(None)
                continue
            fwd = rc = 0
            for j, c in enumerate(km):
                fwd = fwd * 4 + c
                rc += (3 - c) << (2 * j)
            kms.append(min(fwd, rc))
        for i in range(len(kms) - w + 1):
            live = [x for x in kms[i:i + w] if x is not None]
            if live:
                keys.add(min(live))
    return sorted(keys)


def test_reference_spectrum_by_its_definition():
    from phibench import reference as ref
    rng = np.random.default_rng(4)
    reads = rng.integers(0, 4, (40, 60), dtype=np.uint8)
    reads[rng.random(reads.shape) < 0.05] = 4
    reads[0, 10:30] = 4                   # a window of dead k-mers
    got = ref.read_spectrum(reads, 7, 5, "cpu").tolist()
    assert got == _brute_spectrum(reads, 7, 5)
    rc = np.where(reads == 4, 4, 3 - reads)[:, ::-1].copy()
    assert ref.read_spectrum(rc, 7, 5, "cpu").tolist() == got


def test_no_path_meets_a_model_kmer_twice():
    """The premise of the certificate (check.py): edges run from lower to
    higher node ids, so a path's nodes rise, and every model k-mer's
    occurrences overlap in nodes, so no path covers one k-mer twice and
    the relaxed bound is the exact optimum."""
    import torch

    from phibench import reference as ref
    p = synth.make_panel(3, 60000, 6, 0.01, 0.05, 30)
    e = synth.panel_edges(p)
    assert (e[:, 0] < e[:, 1]).all()
    pi = ref.index_panel(p, 31, 25, "cpu")
    s = synth.make_sample(p, 2**31 + 3, 1, 0, dict(TRAFFIC, coverage=3.0))
    an = ref.anchors(pi, ref.read_spectrum(s.reads, 31, 25, "cpu"), 1.0)
    first = pi.walk_mat[an.occ_hap, an.occ_s]
    last = pi.walk_mat[an.occ_hap, an.occ_e]
    n = int(an.occ_kid.max()) + 1
    lowest_last = torch.full((n,), 2**62).scatter_reduce(
        0, an.occ_kid, last, "amin")
    highest_first = torch.full((n,), -1).scatter_reduce(
        0, an.occ_kid, first, "amax")
    used = torch.unique(an.occ_kid)
    assert len(used) == an.model_kmers > 100
    assert (highest_first[used] <= lowest_last[used]).all()
