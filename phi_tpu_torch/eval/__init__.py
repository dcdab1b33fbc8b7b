"""Synthetic instances and their scoring, for the smoke run and profiles.

The JAX package's generator (`phi_tpu.eval.scale.build_instance`) and
edit-distance scorer (`phi_tpu.eval.edits.edit_stats`) are host numpy code
that loads no jax, so the port reuses them as they are. The eval runners
themselves are not ported yet (ROADMAP.md queue 1).
"""

from phi_tpu.eval.edits import edit_stats
from phi_tpu.eval.scale import build_instance

__all__ = ["build_instance", "edit_stats"]
