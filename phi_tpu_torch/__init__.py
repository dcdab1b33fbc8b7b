"""PHI on PyTorch and CUDA: the port of `phi_tpu` to one NVIDIA H100.

The package mirrors `phi_tpu`'s layout and reuses its jax-free host modules
(`io`, `graph.pangenome`, `native`, `emit`, `config`, `logging`). Device
stages are torch ops on an explicit `torch.device`; the TPU kernels of the
device-anchor routes (the rows3, rows3w and rows2 sketches) are hand-written
CUDA in `csrc/rows.cu`, each with a plain torch twin that runs on CPU
tensors. Nothing here imports jax.
"""

__version__ = "0.1.0"
