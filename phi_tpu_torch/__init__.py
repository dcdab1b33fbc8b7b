"""PHI on PyTorch and CUDA: the port of `phi_tpu` to one NVIDIA H100.

The package mirrors `phi_tpu`'s layout and reuses its jax-free host modules
(`io`, `graph.pangenome`, `native`, `emit`, `config`, `logging`). Device
stages are torch ops on an explicit `torch.device`; the one TPU kernel on
the main path (the rows3 sketch) is hand-written CUDA in `csrc/rows3.cu`,
with a plain torch twin that runs on CPU tensors. Nothing here imports jax.
"""

__version__ = "0.1.0"
