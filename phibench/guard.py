"""The module guard: no module of the JAX package or of JAX may be loaded
in a benchmark run, where the port's own name begins with the JAX
package's. Names are compared by their top-level part, whole."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "phi_tpu"})


def forbidden(names=None) -> list[str]:
    """The loaded modules (or `names`) whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
