"""ApproxPilot on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `repro` that keeps its module layout
(`repro/accel/apps.py` -> `repro_torch/accel/apps.py`). It imports
torch, numpy and networkx only — never jax and never `repro`.

Entry points take a ``device`` argument and run on CUDA unless the caller
passes ``device="cpu"`` (see `repro_torch.device.resolve`). Each kernel
that the JAX package wrote in Pallas for the TPU is a hand-written CUDA
kernel here (`repro_torch.kernels`); on CPU tensors the kernels' plain
PyTorch versions run instead.
"""
