"""The benchmark of `phi_tpu_torch`: one run of one cell.

    python3 phibench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

(or `python3 -m phibench.run ...` from the checkout's root). It sets up
the cell (the panel from phibench/_cache/, built there on the first run;
the program's libraries from their build directories in the checkout; one
warm-up item), measures closed-loop items for `--seconds`, checks a
sample of their answers against the plain reference (reference.py), and
prints the result as the last line of standard output: with --trace 0 the
cell's end-to-end metrics, with --trace 1 its per-layer metrics, read
under torch.profiler. The numbers compared, each beside its limit, are
the last lines of standard error and the last key of the result.

It exits 2 without the CUDA devices the cell asks for, and 3, printing no
result, when a forbidden module (guard.py) was loaded in it or in a child.
"""

from __future__ import annotations

import os
import sys
import time

_T0 = time.monotonic()
_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == _HERE:
    sys.path[0] = _ROOT          # run as a script: import from the root
elif _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(_HERE, "_cache", _sub)


def process_age() -> float:
    """Seconds since this process started (from /proc where it exists,
    else since this module was loaded)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T0


def main(argv: list[str] | None = None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(prog="phibench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    a = p.parse_args(argv)

    import torch

    from phibench import guard, harness
    run = harness.Run(a.workload, a.seed, a.seconds, bool(a.trace))
    chips = int(run.cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[phibench] {a.workload} needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = harness.execute(run, process_age)
    bad = guard.forbidden() + sorted(set(getattr(run, "child_forbidden",
                                                 [])))
    if bad:
        print(f"[phibench] forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for r in run.records:
        t = r.get("timings", {})
        extra = "".join(f" {k}={r[k]:.3f}" for k in ("age_at_entry_s",
                                                      "lead_s") if k in r)
        print(f"[phibench] item {r['index']}: wall={r['wall_s']:.3f} "
              f"total={t.get('total', float('nan')):.3f} ok={r.get('ok')}"
              f"{extra} " + " ".join(f"{k}={v:.3f}" for k, v in t.items()
                                     if k != "total"), file=sys.stderr)
    for err in res.get("errors", []):
        print(f"[phibench] item failed: {err}", file=sys.stderr)
    print(json.dumps(res), flush=True)
    sys.stderr.write(f"[phibench] card: {card_line()}\n")
    sys.stderr.write(f"[phibench] correct: {res['correct']} "
                     f"({res['attempted']} attempted, {res['failed']} "
                     "failed)\n")
    for name, (val, lim) in res["checks"].items():
        sys.stderr.write(f"[phibench] check {name}: {val} (limit {lim})\n")
    sys.stderr.flush()
    return 0


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "not read"


if __name__ == "__main__":
    sys.exit(main())
