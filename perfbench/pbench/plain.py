"""Plain layers of the references: PyTorch operations in float32, no
kernels, no cache, no batching tricks.

Every weight product goes through `matmul`, which with
``precision="fp8"`` first rounds both operands to float8 e4m3 (a scale
per activation row and per weight column, the largest value at 448)
and then multiplies in float32: the reference computed one precision
below the configuration's bf16, which serves as the control that a
comparison has to fail.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "fp8")
FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale per slice along ``dim``."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    # the rounding passes gradients straight through
    return x + (q - x).detach()


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., k) @ w (k, n) in float32."""
    x, w = x.float(), w.float()
    if precision == "fp8":
        x, w = _fp8(x, -1), _fp8(w, 0)
    elif precision != "float32":
        raise ValueError(f"precision {precision!r}; one of {PRECISIONS}")
    return x @ w


def layers(w: dict) -> list:
    """Each layer's weights, by name within the block (one ``unbind`` a
    stacked leaf, so a gradient stacks once)."""
    cols = {k[len("blocks/"):]: v.unbind(0) for k, v in w.items()
            if k.startswith("blocks/")}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * gamma.float()


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                sections=()) -> torch.Tensor:
    """(B,S,head_dim/2) angles; with ``sections`` (M-RoPE) frequency band
    i turns with position column i % 3 of (B,S,3) positions."""
    half = head_dim // 2
    inv_freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                       device=positions.device) / half)
    pos = positions.float()
    if not sections:
        return pos[..., None] * inv_freq
    cols = torch.cat([torch.full((n,), i % pos.shape[-1],
                                 device=positions.device, dtype=torch.long)
                      for i, n in enumerate(sections)])
    return pos[..., cols] * inv_freq


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B,S,H,D), rotate-half layout."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos, sin = torch.cos(angles)[:, :, None], torch.sin(angles)[:, :, None]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Causal grouped-query attention, one batch row at a time: q
    (B,S,H,D), k and v (B,S,KV,D)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    pos = torch.arange(S, device=q.device)
    allowed = pos[None, :] <= pos[:, None]
    out = []
    for b in range(B):
        qb = q[b].reshape(S, KV, G, D)
        s = torch.einsum("qkgd,skd->kgqs", qb, k[b]) * D ** -0.5
        p = torch.softmax(s.masked_fill(~allowed, float("-inf")), dim=-1)
        out.append(torch.einsum("kgqs,skd->qkgd", p, v[b]).reshape(S, H, D))
    return torch.stack(out)


def mlp(x: torch.Tensor, w_gate, w_up, w_down, precision: str):
    return matmul(F.silu(matmul(x, w_gate, precision))
                  * matmul(x, w_up, precision), w_down, precision)


def attention_branch(conf: dict, p: dict, nx: torch.Tensor,
                     positions: torch.Tensor, precision: str):
    """Self-attention of one layer: (output (B,S,d), k (B,S,KV,D) after
    the rotation, v)."""
    B, S, _ = nx.shape
    H, KV, D = conf["n_heads"], conf["n_kv_heads"], conf["head_dim"]
    q = matmul(nx, p["attn/wq"], precision)
    k = matmul(nx, p["attn/wk"], precision)
    v = matmul(nx, p["attn/wv"], precision)
    if conf.get("qkv_bias"):
        q = q + p["attn/bq"].float()
        k = k + p["attn/bk"].float()
        v = v + p["attn/bv"].float()
    q, k, v = (q.reshape(B, S, H, D), k.reshape(B, S, KV, D),
               v.reshape(B, S, KV, D))
    ang = rope_angles(positions, D, conf["rope_theta"],
                      tuple(conf.get("mrope_sections") or ()))
    q, k = apply_rope(q, ang), apply_rope(k, ang)
    o = attention(q, k, v)
    return matmul(o.reshape(B, S, H * D), p["attn/wo"], precision), k, v

