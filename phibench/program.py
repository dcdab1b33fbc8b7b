"""The benchmark's door into the program, `phi_tpu_torch`: its command
line (`cli.build_parser`, `cli.options_from_args`), `run_pipeline`, and
the counters of its cross-run caches. Nothing here computes a result."""

from __future__ import annotations


def argv(run, reads: str | None, out: str, R=None, extra=()) -> list[str]:
    """The command line of one inference with the configuration's
    parameters: -r reads, or `extra` such as --load-index."""
    p = run.params
    a = ["-g", run.gfa] + (["-r", reads] if reads else []) + [
        "-o", out, "-k", str(p["k"]), "-w", str(p["w"]),
        "-R", str(R if R is not None else p["R"]), "-T", str(p["T"]),
        "--device", run.device]
    return a + list(extra)


def pipeline(args: list[str]):
    """What `python -m phi_tpu_torch.cli args` runs, returning the
    pipeline's result."""
    from phi_tpu_torch import cli
    from phi_tpu_torch import logging as plog
    from phi_tpu_torch.pipeline import resolve_device, run_pipeline
    ns = cli.build_parser().parse_args(args)
    plog.reset_timer()
    return run_pipeline(ns.gfa, ns.reads, ns.out, cli.options_from_args(ns),
                        device=resolve_device(ns.device))


def outputs(result, fasta: str, R: float, tol: float) -> dict:
    """The program's answer as the check reads it."""
    a, d = result.anchors, result.decode
    return {"spectrum_size": int(a.spectrum_size),
            "minimizers": [int(x) for x in a.per_hap_minimizers],
            "anchors": [int(x) for x in a.per_hap_anchors],
            "filtered": int(a.filtered_kmers),
            "model_kmers": int(a.n_model_kmers),
            "bound": float(d.dp_objective),
            "objective": float(d.true_objective),
            "certified": float(d.true_objective - d.dp_objective) <= tol,
            "segments": [[int(x) for x in s] for s in d.segments],
            "recombinations": int(result.recombination_count),
            "report": list(result.report_segments),
            "fasta": fasta, "R": float(R)}


def clear_caches() -> None:
    """Drop the program's cross-run device caches."""
    from phi_tpu_torch.eval.onchip import clear_caches as clear
    clear()
