"""phibench: the benchmark of the PyTorch and CUDA port, phi_tpu_torch
(run.py says how to run it; harness.py how it finds its parts)."""
