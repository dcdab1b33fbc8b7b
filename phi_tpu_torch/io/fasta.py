"""FASTA output with the reference's naming and layout (the port's copy of
`phi_tpu/io/fasta.py`).

- Record id is `{gfa_basename}_{reads_basename}` with extensions stripped
  (get_hap_name, PHI's `src/misc.cpp:58-87`).
- Header carries ` LN:{length}` and the body wraps at 80 columns
  (ILP_index.cpp:1590-1598).
"""

from __future__ import annotations

import os


def hap_name_from_paths(gfa_path: str, reads_path: str) -> str:
    g = os.path.basename(gfa_path)
    g = g[:g.rfind(".")] if "." in g else g
    r = os.path.basename(reads_path)
    name = f"{g}_{r}"
    # reference strips one trailing extension from the *combined* name
    # (misc.cpp:80-83), so "x.fq.gz" contributes "x.fq".
    name = name[:name.rfind(".")] if "." in name else name
    return name


def write_fasta(path: str, name: str, seq: str, width: int = 80) -> None:
    with open(path, "w") as fh:
        fh.write(f">{name} LN:{len(seq)}\n")
        for i in range(0, len(seq), width):
            fh.write(seq[i:i + width] + "\n")
