"""Synthetic instances and their scoring, for the smoke run and profiles:
the port's copies of the JAX package's generator (`eval/synth.py`,
`eval/scale.py`: `build_instance` writes byte-identical instances from the
same seed) and edit-distance scorer (`eval/edits.py`, the native banded
Myers distance). Of the eval runners, `eval/frontier.py` is ported; the
others are not yet (ROADMAP.md queue 1, item 10).
"""

from phi_tpu_torch.eval.edits import edit_stats
from phi_tpu_torch.eval.scale import build_instance

__all__ = ["build_instance", "edit_stats"]
