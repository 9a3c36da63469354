"""Plain PyTorch versions of the kernels (the CPU path and the yardstick
each CUDA kernel is held against)."""
from __future__ import annotations

import torch


def gnn_mp_ref(adj, h, w_self, w_nbr, b):
    """Fused GNN message passing: relu(A @ (H @ Wn) + H @ Ws + b).

    adj: (B,N,N) or a shared (N,N); h: (B,N,F); w_*: (F,Fo); b: (Fo,).
    """
    return torch.relu(adj @ (h @ w_nbr) + h @ w_self + b)


def lut_eval_ref(lut, a, b, wb: int):
    """int32 gather ``lut[(a << wb) | b]``.

    A negative index counts from the end of the table and an index still
    out of range is clamped, so an operand outside the table's domain never
    reads outside the table (the CUDA kernel does the same; the apps'
    domain guard reports such operands)."""
    n = lut.shape[0]
    idx = (a << wb) | b
    idx = torch.where(idx < 0, idx + n, idx).clamp_(0, n - 1)
    return lut[idx.long()]
