"""Why are some ground-truth floor wins thin? The port's copy of
`phi_tpu/eval/floor_diag.py`: both inferences run the port's pipeline on
`device`.

For samples whose mosaic barely beats the best-single-panel-hap floor,
decompose the ceiling:

  floor          best single panel hap (no recombination) — the baseline
  inferred@10x   the solver's mosaic at high coverage, production R=100
  oracle(R=1)    the mosaic at a near-free-recombination operating point
                 (10x). NOT a strict bound: the objective maximizes
                 covered k-mers, and free switching can ADD edits at
                 switch junctions.

Reading: where inferred@10x ~= oracle(R=1), more switching buys nothing —
the residual tracks panel distance (truth content absent from every panel
hap) and the ceiling is the PANEL. Where oracle(R=1) is clearly better,
the production R=100 is leaving recoverable signal on the table — a
parameter ceiling, not a panel one.

    python -m phi_tpu_torch.eval.floor_diag --out bench_results/floor_diag \
        [--samples COX,MANN,PGF,KAS116] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

DIAG_SAMPLES = ("COX", "MANN", "PGF", "KAS116")


def diagnose(samples=DIAG_SAMPLES, coverage: float = 10.0,
             seed: int = 1007, progress=True, device="cuda",
             truth_dir: str | None = None) -> dict:
    """One row per sample: the floor, the production inference and the
    R = 1 oracle on `device`, truths read from `truth_dir`
    (groundtruth.GROUND_TRUTH_DIR when None)."""
    from phi_tpu_torch.config import Options
    from phi_tpu_torch.eval.groundtruth import (PANEL_GFA, infer_cell,
                                                load_truth,
                                                panel_floor_cached)
    from phi_tpu_torch.graph.pangenome import tensorize
    from phi_tpu_torch.io.gfa import read_gfa
    from phi_tpu_torch.pipeline import resolve_device

    device = resolve_device(device)
    graph = tensorize(read_gfa(PANEL_GFA))
    rows = []
    for sample in samples:
        truth = load_truth(sample, truth_dir)
        floor_name, floor_ed = panel_floor_cached(graph, truth, sample,
                                                  PANEL_GFA)
        t0 = time.time()
        prod = infer_cell(PANEL_GFA, truth, coverage, seed=seed,
                          escalate_tol=0.5, device=device)
        oracle = infer_cell(PANEL_GFA, truth, coverage, seed=seed,
                            opt=Options(recombination=1.0,
                                        lagrangian_rounds=2), device=device)
        panel_gap_pct = round(100.0 * oracle["edit"]
                              / max(1, len(truth)), 3)
        solver_headroom = prod["edit"] - oracle["edit"]
        rows.append({
            "sample": sample,
            "truth_len": len(truth),
            "floor_edit": floor_ed, "floor_hap": floor_name,
            "inferred_10x_edit": prod["edit"],
            "inferred_recombinations": prod["recombinations"],
            "oracle_R1_edit": oracle["edit"],
            "oracle_R1_recombinations": oracle["recombinations"],
            "panel_absent_pct_of_truth": panel_gap_pct,
            "solver_headroom_edit": solver_headroom,
            "ceiling": "panel" if solver_headroom
            <= max(0.1 * oracle["edit"], 200) else "solver",
            "wall_s": round(time.time() - t0, 1),
        })
        if progress:
            print(f"[diag] {sample}: floor {floor_ed} inferred "
                  f"{prod['edit']} oracle(R=1) {oracle['edit']} -> "
                  f"ceiling={rows[-1]['ceiling']}",
                  file=sys.stderr, flush=True)
    return {"coverage": coverage, "seed": seed, "rows": rows,
            "note": "oracle(R=1) = near-free-recombination operating "
                    "point, not a strict bound (free switching can add "
                    "junction edits - see KAS116). inferred ~= oracle => "
                    "the residual is panel distance (content absent from "
                    "every panel hap); oracle clearly better => the "
                    "production R is the ceiling (parameter, not panel)"}


def to_md(result: dict) -> str:
    lines = ["## Floor-win diagnosis (weak-win samples)", "",
             "| sample | floor | inferred@10x (recombs) | oracle R=1 "
             "(recombs) | panel-absent %truth | solver headroom | "
             "ceiling |", "|---|---|---|---|---|---|---|"]
    for r in result["rows"]:
        lines.append(
            f"| {r['sample']} | {r['floor_edit']} | "
            f"{r['inferred_10x_edit']} ({r['inferred_recombinations']}) | "
            f"{r['oracle_R1_edit']} ({r['oracle_R1_recombinations']}) | "
            f"{r['panel_absent_pct_of_truth']}% | "
            f"{r['solver_headroom_edit']} | {r['ceiling']} |")
    lines += ["", result["note"], ""]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="phi-torch-floor-diag")
    ap.add_argument("--out", default="bench_results/floor_diag")
    ap.add_argument("--samples", default=",".join(DIAG_SAMPLES))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="torch device of the pipeline runs [cuda]")
    args = ap.parse_args(argv)
    try:
        res = diagnose(samples=args.samples.split(","), device=args.device)
    except (ValueError, OSError, RuntimeError) as e:
        sys.stderr.write(f"[E::main] {e}\n")
        return 1
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out + ".json", "w") as f:
        json.dump(res, f, indent=1)
    with open(args.out + ".md", "w") as f:
        f.write(to_md(res))
    print(json.dumps({"rows": len(res["rows"]),
                      "panel_ceiling": sum(1 for r in res["rows"]
                                           if r["ceiling"] == "panel")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
