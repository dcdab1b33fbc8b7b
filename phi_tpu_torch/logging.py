"""Phase-log contract: `[M::<func>::<realtime>*<cpu/real>] message` lines on stderr
(the port's copy of `phi_tpu/logging.py`).

This format is machine-parsed by the reference's postprocessing scripts
(PHI's `data/postprocessing.py:50-76`); we emit the same shape so the
eval harness (and any downstream tooling written for PHI) works unchanged.
Reference implementation: realtime()/cputime() in PHI's
`src/sys.cpp:92-117`.
"""

from __future__ import annotations

import resource
import sys
import time

_T0 = time.time()


def reset_timer() -> None:
    global _T0
    _T0 = time.time()


def realtime() -> float:
    return time.time() - _T0


def cputime() -> float:
    ru_self = resource.getrusage(resource.RUSAGE_SELF)
    ru_kids = resource.getrusage(resource.RUSAGE_CHILDREN)
    return (ru_self.ru_utime + ru_self.ru_stime
            + ru_kids.ru_utime + ru_kids.ru_stime)


def peakrss_gb() -> float:
    # ru_maxrss is KiB on Linux
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0 / 1024.0


def log(func: str, msg: str) -> None:
    rt = realtime()
    ratio = cputime() / rt if rt > 0 else 0.0
    sys.stderr.write(f"[M::{func}::{rt:.3f}*{ratio:.2f}] {msg}\n")
    sys.stderr.flush()


def raw(msg: str) -> None:
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def footer(version: str, argv: list[str]) -> None:
    raw(f"[M::main] PHI Version: {version}")
    raw("[M::main] CMD: " + " ".join(argv))
    raw(f"[M::main] Real time: {realtime():.3f} sec; CPU: {cputime():.3f} sec; "
        f"Peak RSS: {peakrss_gb():.3f} GB")
