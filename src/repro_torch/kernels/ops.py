"""Per-device dispatch of the kernels.

A tensor on the CPU goes to the kernel's plain PyTorch version
(`kernels.ref`); a CUDA tensor goes to the hand-written kernel, whose
wrapper raises on anything it cannot launch. There is no fallback from
the kernel to the plain version: which one ran follows from the device.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gnn_mp as _mp
from repro_torch.kernels import lut_eval as _lut
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as _scan


def gnn_mp(adj, h, w_self, w_nbr, b):
    """relu(A @ (H @ Wn) + H @ Ws + b); adj (N,N) shared or (B,N,N)."""
    if h.device.type == "cpu":
        return ref.gnn_mp_ref(adj, h, w_self, w_nbr, b)
    return _mp.gnn_mp(adj, h, w_self, w_nbr, b)


def lut_eval(lut, a, b=None, wb: int = 0):
    """int32 gather ``lut[(a << wb) | b]`` over 1-D a, b; ``lut[a]``
    when b is None (wb must be 0)."""
    if a.device.type == "cpu":
        return ref.lut_eval_ref(lut, a, b, wb)
    return _lut.lut_eval(lut, a, b, wb)


def flash_attention(q, k, v, *, causal: bool = True):
    """Attention with grouped KV heads; q (B,H,S,D), k/v (B,KV,S,D)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    return _fa.flash_attention(q, k, v, causal=causal)


def ssm_scan(a, b, y0):
    """y_t = a_t * y_{t-1} + b_t over (T,D); `a` is (T,D) or a compact
    (T,D/R) shared by R neighbouring channels. Returns (ys, y_final)."""
    if b.device.type == "cpu":
        rep = _scan.repeat_factor(a, b)
        return ref.ssm_scan_ref(a.repeat_interleave(rep, dim=1), b, y0)
    return _scan.ssm_scan(a, b, y0)
