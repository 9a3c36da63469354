"""Wrapper of the CUDA kernel ``csrc/gnn_mp.cu``: one fused GNN layer
relu(A @ (H @ Wn) + H @ Ws + b) over a batch of small dense graphs."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = build.LaunchCounter()
MAX_NODES = 64


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gnn_mp_launch.argtypes = [p, ctypes.c_longlong, p, p, p, p, p,
                                  i, i, i, i, p]
    lib.gnn_mp_launch.restype = i


def gnn_mp(adj: torch.Tensor, h: torch.Tensor, w_self: torch.Tensor,
           w_nbr: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel. h: (B,N,F); w_*: (F,Fo); b: (Fo,); adj: (N,N)
    shared by every graph, or (B,N,N) — a broadcast view with batch
    stride 0 is read without copying. All float32 on one CUDA device.
    Returns (B,N,Fo) float32."""
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"gnn_mp kernel needs CUDA tensors, got {dev}")
    tensors = {"adj": adj, "h": h, "w_self": w_self, "w_nbr": w_nbr, "b": b}
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"gnn_mp: {name} must be float32 on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if h.dim() != 3 or not h.is_contiguous():
        raise ValueError(f"gnn_mp: h must be a contiguous (B,N,F) tensor, "
                         f"got shape {tuple(h.shape)}")
    B, N, F = h.shape
    if w_self.dim() != 2 or w_self.shape[0] != F:
        raise ValueError(f"gnn_mp: w_self must be (F={F}, Fo), got "
                         f"{tuple(w_self.shape)}")
    Fo = w_self.shape[1]
    if tuple(w_nbr.shape) != (F, Fo) or tuple(b.shape) != (Fo,):
        raise ValueError(f"gnn_mp: w_nbr must be ({F},{Fo}) and b ({Fo},), "
                         f"got {tuple(w_nbr.shape)} and {tuple(b.shape)}")
    for name in ("w_self", "w_nbr", "b"):
        if not tensors[name].is_contiguous():
            raise ValueError(f"gnn_mp: {name} must be contiguous")
    if not 1 <= N <= MAX_NODES:
        raise ValueError(f"gnn_mp: graphs of {N} nodes; the kernel takes "
                         f"1..{MAX_NODES}")
    graphs_per_block = MAX_NODES // N
    if -(-B // graphs_per_block) > 65535:
        raise ValueError(f"gnn_mp: a batch of {B} graphs of {N} nodes "
                         f"exceeds one launch's grid; split the batch")
    if adj.dim() == 2 and tuple(adj.shape) == (N, N) and adj.is_contiguous():
        adj_stride = 0
    elif (adj.dim() == 3 and tuple(adj.shape) == (B, N, N)
          and adj.stride()[1:] == (N, 1) and adj.stride(0) in (0, N * N)):
        adj_stride = adj.stride(0)
    else:
        raise ValueError(f"gnn_mp: adj must be a contiguous ({N},{N}) or a "
                         f"({B},{N},{N}) tensor with row-major graphs, got "
                         f"shape {tuple(adj.shape)} strides {adj.stride()}")
    out = torch.empty((B, N, Fo), device=dev, dtype=torch.float32)
    if B == 0 or Fo == 0:
        return out
    lib = build.load("gnn_mp", _declare)
    with torch.cuda.device(dev):
        err = lib.gnn_mp_launch(
            adj.data_ptr(), adj_stride, h.data_ptr(), w_self.data_ptr(),
            w_nbr.data_ptr(), b.data_ptr(), out.data_ptr(), B, N, F, Fo,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gnn_mp kernel launch failed: CUDA error {err}")
    LAUNCHES.add()
    return out
