"""Plain PyTorch versions of the kernels (the CPU path and the yardstick
each CUDA kernel is held against)."""
from __future__ import annotations

import torch

from repro_torch.kernels.lut_eval import check_b


def gnn_mp_ref(adj, h, w_self, w_nbr, b):
    """Fused GNN message passing: relu(A @ (H @ Wn) + H @ Ws + b).

    adj: (B,N,N) or a shared (N,N); h: (B,N,F); w_*: (F,Fo); b: (Fo,).
    """
    return torch.relu(adj @ (h @ w_nbr) + h @ w_self + b)


def lut_eval_ref(lut, a, b=None, wb: int = 0):
    """int32 gather ``lut[(a << wb) | b]``; b None stands for b = 0 and
    needs wb == 0 (the index is a).

    A negative index counts from the end of the table and an index still
    out of range is clamped, so an operand outside the table's domain never
    reads outside the table (the CUDA kernel does the same; the apps'
    domain guard reports such operands)."""
    check_b(b, wb)
    n = lut.shape[0]
    idx = a if b is None else (a << wb) | b
    idx = torch.where(idx < 0, idx + n, idx).clamp_(0, n - 1)
    return lut[idx.long()]


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Causal or full attention with grouped KV heads.

    q: (B,H,Sq,D); k, v: (B,KV,Sk,D) with H = KV*G, query head h reading
    KV head h // G, and Sq <= Sk: under ``causal`` query row i sits at key
    position Sk - Sq + i (the mask aligned bottom-right; with Sq == Sk the
    lower triangle). Scores in float32 scaled by D^-0.5, masked with
    -1e30, softmax in float32, probabilities rounded to v's type before
    the PV product (the reference kernel's order). Returns (B,H,Sq,D) in
    v's type.
    """
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    q5 = q.reshape(B, KV, G, Sq, D).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", q5, k.float()) * D ** -0.5
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(Sk - Sq)
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v)
    return o.reshape(B, H, Sq, D)


def rms_norm_ref(x, gamma, eps: float):
    """RMSNorm over the last dimension: x * rsqrt(mean(x^2) + eps) * gamma
    in float32 (in x's type where that is wider), rounded once to x's
    type."""
    dt = x.dtype
    x = x.to(torch.promote_types(dt, torch.float32))
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * gamma.to(x.dtype)).to(dt)


def ssm_scan_ref(a, b, y0):
    """Diagonal linear recurrence y_t = a_t * y_{t-1} + b_t.

    a, b: (T,D) float32; y0: (D,). Returns ys (T,D) and y_final (D,)."""
    ys = torch.empty_like(b)
    y = y0
    for t in range(b.shape[0]):
        y = a[t] * y + b[t]
        ys[t] = y
    return ys, y.clone()
