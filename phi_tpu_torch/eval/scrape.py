"""Phase-log scraping — the machine-parsed contract of PHI's stderr output
(the port's copy of `phi_tpu/eval/scrape.py`).

Mirrors the reference's postprocessing regexes
(PHI's `data/postprocessing.py:50-76`): spectrum size,
filtered/retained minimizers, % minimizers in ILP, recombination count,
real/CPU time, and peak RSS. Works on logs of the port
(`phi_tpu_torch.logging` writes the same lines), of `phi_tpu` and of the
reference binary alike (same line shapes).
"""

from __future__ import annotations

import re


_PATTERNS = {
    "spectrum_size": re.compile(r"Indexed reads with spectrum size:\s*(\d+)"),
    "filtered_pct": re.compile(r"Filtered/Retained Minimizers:\s*([\d.]+)/([\d.]+)%"),
    "pct_in_ilp": re.compile(r"([\d.]+)% Minimizers are in ILP"),
    "recombination_count": re.compile(r"Recombination count:\s*(\d+)"),
    "real_time": re.compile(r"Real time:\s*([\d.]+) sec"),
    "cpu_time": re.compile(r"CPU:\s*([\d.]+) sec"),
    "peak_rss_gb": re.compile(r"Peak RSS:\s*([\d.]+) GB"),
    "haplotype_size": re.compile(r"Haplotype of size:\s*(\d+)"),
    "recombined_haplotypes": re.compile(r"Recombined haplotypes:\s*(\S+)"),
    "dp_gap": re.compile(r"gap:\s*([\d.eE+-]+)"),
}


def scrape_log(text: str) -> dict:
    out: dict = {}
    for key, pat in _PATTERNS.items():
        m = pat.search(text)
        if not m:
            continue
        if key == "filtered_pct":
            out["filtered_pct"] = float(m.group(1))
            out["retained_pct"] = float(m.group(2))
        elif key in ("spectrum_size", "recombination_count", "haplotype_size"):
            out[key] = int(m.group(1))
        elif key == "recombined_haplotypes":
            out[key] = m.group(1)
        else:
            out[key] = float(m.group(1))
    return out


def scrape_log_file(path: str) -> dict:
    with open(path) as f:
        return scrape_log(f.read())
