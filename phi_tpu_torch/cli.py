"""Command line of the PyTorch/CUDA port: the `phi_tpu` flag surface plus
--device.

    python -m phi_tpu_torch.cli -g graph.gfa -r reads.fq -o hap.fa \
        [-k 31 -w 25 -R 100 -T 1.0 ... --device cuda] [--save-index IDX.npz]
    python -m phi_tpu_torch.cli -g graph.gfa --load-index IDX.npz -o hap.fa \
        [-R 50 ...]

--save-index writes the read spectrum and the per-haplotype join hits (the
`.npz` of `phi_tpu`'s checkpoint: either package loads the other's);
--load-index reads them instead of the reads (-r is then optional), so a
re-solve with other solver parameters skips all sketching. Both need k <= 31
and walks of A/C/G/T only.

-d 1 prints the reference's debug detail: the k-mer sharing histogram,
a model dump (one summary line for a large model) and the chosen path's
[D] segment lines. --race {auto,on,off} is accepted so that `phi` command
lines run unchanged, and does nothing: the reference races a CPU run only
against a remote TPU's first compiles.

--device cuda (the default) needs a CUDA device: without one the command
prints [E::main] and exits 1; it never runs on the CPU instead. --mesh is
not ported yet and is rejected the same way.
"""

from __future__ import annotations

import argparse
import sys

from phi_tpu_torch import logging as plog
from phi_tpu_torch.config import Options
from phi_tpu_torch import __version__


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="phi-torch",
        description="PHI: pangenome haplotype inference (PyTorch/CUDA port)")
    p.add_argument("-g", dest="gfa", required=False, help="GFA file")
    p.add_argument("-r", dest="reads", required=False,
                   help="reads (FASTA/FASTQ); optional with --load-index")
    p.add_argument("-o", dest="out", required=False, help="output haplotype FASTA")
    p.add_argument("-k", type=int, default=31, help="k-mer size [31]")
    p.add_argument("-w", type=int, default=25, help="minimizer window size [25]")
    p.add_argument("-R", type=float, default=100, help="recombination penalty [100]")
    p.add_argument("-T", type=float, default=1.0, help="minimizer filter threshold [1.0]")
    p.add_argument("-q", type=int, default=1, help="mode QP/ILP (compat) [1]")
    p.add_argument("-m", type=int, default=1, help="mixed/integer (compat) [1]")
    p.add_argument("-N", type=int, default=0, help="naive expanded graph (compat) [0]")
    p.add_argument("-t", type=int, default=0, help="host threads (0 = auto)")
    p.add_argument("-c", type=int, default=5000, help="max k-mer occurrence (compat) [5000]")
    p.add_argument("-d", type=int, default=0, help="debug mode [0]")
    p.add_argument("--sweeps", type=int, default=256, help="DP sweep cap [256]")
    p.add_argument("--lagrangian", type=int, default=8,
                   help="Lagrangian refinement rounds when gap > 0 [8]")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device for the sketch, join and solver [cuda]")
    p.add_argument("--mesh", type=int, default=0, help="(not yet ported)")
    p.add_argument("--save-index", default=None, metavar="NPZ",
                   help="write the spectrum + join-hit checkpoint here")
    p.add_argument("--load-index", default=None, metavar="NPZ",
                   help="solve from a checkpoint (skips reads and sketching)")
    p.add_argument("--race", choices=["auto", "on", "off"], default=None,
                   help="accepted for phi command lines; no effect")
    p.add_argument("--version", action="store_true", help="print version")
    return p


def options_from_args(args) -> Options:
    return Options(k=args.k, w=args.w, recombination=args.R,
                   threshold=args.T, is_qclp=args.q, is_mixed=args.m,
                   is_naive_exp=args.N, num_threads=args.t, max_occ=args.c,
                   debug=bool(args.d), max_sweeps=args.sweeps,
                   lagrangian_rounds=args.lagrangian,
                   save_index=args.save_index, load_index=args.load_index)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    if args.version:
        print(f"PHI version: {__version__}")
        return 0
    if args.mesh:
        sys.stderr.write("[E::main] --mesh is not yet ported to "
                         "phi_tpu_torch\n")
        return 1
    if not (args.gfa and args.out and (args.reads or args.load_index)):
        build_parser().print_usage(sys.stderr)
        return 1

    plog.reset_timer()
    if args.race:
        plog.log("main", f"--race {args.race}: no effect (phi races a CPU run "
                 "only against a remote TPU's first compiles)")
    try:
        from phi_tpu_torch.pipeline import resolve_device, run_pipeline
        device = resolve_device(args.device)
        run_pipeline(args.gfa, args.reads, args.out, options_from_args(args),
                     device=device)
    except (ValueError, OSError, RuntimeError) as e:
        # load failures, unported routes (NotImplementedError) and a missing
        # CUDA device end as [E::main] and exit 1, without a traceback
        sys.stderr.write(f"[E::main] {e}\n")
        return 1
    plog.footer(__version__, ["phi-torch"] + argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
