"""Per-device dispatch of the kernels.

A tensor on the CPU goes to the kernel's plain PyTorch version
(`kernels.ref`); a CUDA tensor goes to the hand-written kernel, whose
wrapper raises on anything it cannot launch. There is no fallback from
the kernel to the plain version: which one ran follows from the device.
"""
from __future__ import annotations

from repro_torch.kernels import gnn_mp as _mp
from repro_torch.kernels import lut_eval as _lut
from repro_torch.kernels import ref


def gnn_mp(adj, h, w_self, w_nbr, b):
    """relu(A @ (H @ Wn) + H @ Ws + b); adj (N,N) shared or (B,N,N)."""
    if h.device.type == "cpu":
        return ref.gnn_mp_ref(adj, h, w_self, w_nbr, b)
    return _mp.gnn_mp(adj, h, w_self, w_nbr, b)


def lut_eval(lut, a, b, wb: int):
    """int32 gather ``lut[(a << wb) | b]`` over 1-D a, b."""
    if a.device.type == "cpu":
        return ref.lut_eval_ref(lut, a, b, wb)
    return _lut.lut_eval(lut, a, b, wb)
