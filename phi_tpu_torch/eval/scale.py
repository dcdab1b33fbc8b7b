"""Reference-shaped synthetic instances: the JAX package's generator
(`phi_tpu/eval/scale.py`), copied so that the port builds byte-identical
instances from the same seed into the same cache directory names.

The scale runners of the JAX package (which drive its pipeline) are not
copied; `build_instance` and `instance_dir` are what the port's smoke run
and profiles use.
"""

from __future__ import annotations

import gzip
import json
import os
import tempfile

import numpy as np

from phi_tpu_torch.eval.synth import sample_reads, synth_pangenome
from phi_tpu_torch.io.gfa import write_gfa

CACHE_DIR = os.environ.get("PHI_TPU_SCALE_CACHE",
                           os.path.join(tempfile.gettempdir(),
                                        "phi_tpu_scale"))


def instance_dir(n_haps: int, length: int, coverage: float, seed: int,
                 var_rate: float, error_rate: float, n_breaks: int,
                 read_len: int = 150) -> str:
    tag = (f"h{n_haps}_L{length}_c{coverage:g}_s{seed}_v{var_rate:g}"
           f"_e{error_rate:g}_b{n_breaks}")
    if read_len != 150:
        tag += f"_r{read_len}"
    return os.path.join(CACHE_DIR, tag)


def build_instance(n_haps: int, length: int = 5_000_000, coverage: float = 2.0,
                   seed: int = 0, var_rate: float = 0.01,
                   error_rate: float = 0.002, n_breaks: int = 2,
                   indel_fraction: float = 0.05,
                   read_len: int = 150) -> dict[str, str]:
    """Materialize (or reuse) a cached instance; returns its file paths.

    The read target is a recombinant mosaic of panel haplotypes with
    n_breaks switchpoints (the inference task the reference's benchmark
    exercises: infer a recombined haplotype from low-coverage reads)."""
    d = instance_dir(n_haps, length, coverage, seed, var_rate, error_rate,
                     n_breaks, read_len)
    paths = {"gfa": os.path.join(d, "graph.gfa"),
             "reads": os.path.join(d, "reads.fq.gz"),
             "truth": os.path.join(d, "truth.fa"),
             "meta": os.path.join(d, "meta.json")}
    if all(os.path.exists(p) for p in paths.values()):
        return paths
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    graph, hap_seqs = synth_pangenome(rng, length=length, n_haps=n_haps,
                                      var_rate=var_rate,
                                      indel_fraction=indel_fraction)
    breaks = []
    if n_breaks:
        bpos = np.sort(rng.integers(length // 10, length - length // 10,
                                    n_breaks))
        haps = rng.permutation(n_haps)[:n_breaks + 1]
        breaks = [(int(p), int(h)) for p, h in zip(bpos, haps[1:])]
    reads, target = sample_reads(rng, hap_seqs, coverage=coverage,
                                 read_len=read_len, error_rate=error_rate,
                                 recomb_breaks=breaks)
    write_gfa(graph, path=paths["gfa"])
    with gzip.open(paths["reads"], "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    with open(paths["truth"], "w") as f:
        f.write(">truth\n")
        for i in range(0, len(target), 80):
            f.write(target[i:i + 80] + "\n")
    with open(paths["meta"], "w") as f:
        json.dump({"n_haps": n_haps, "length": length, "coverage": coverage,
                   "seed": seed, "breaks": breaks, "n_reads": len(reads)},
                  f)
    return paths
