"""RWKV-6 (Finch) time-mix and channel-mix blocks [arXiv:2404.05892], in
PyTorch.

The port of `repro.models.rwkv`. Data-dependent per-channel decay
w_t = exp(-exp(w0 + lora(x_t))), a per-head matrix state S (B, H, Dk, Dv)
in float32 and a bonus ``u`` for the current token:
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
The projections are plain ``@`` in the compute type, as in the
reference. The recurrence is a Python loop over time (the reference's
``lax.scan``; no TPU kernel covers it) that issues three operations a
step, in place (out of place while autograd records): the bonus term
r_t^T diag(u) k_t v_t^T = (r_t . u k_t) v_t needs no state, so it is
computed for every t at once outside the loop.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import ParamTable, head_axis, wide

LORA_R = 64


def declare_rwkv(t: ParamTable, prefix: str, cfg: ArchConfig, n_layers: int):
    d, L = cfg.d_model, n_layers
    H = cfg.n_heads
    Dh = cfg.resolved_head_dim
    for name in ("r", "k", "v", "g", "w"):
        t.add(f"{prefix}/mix_{name}", (L, d), ("layers", "embed"),
              init="zeros")
    ha = head_axis(H)
    for name in ("r", "k", "v", "g"):
        t.add(f"{prefix}/w_{name}", (L, d, H * Dh), ("layers", "embed", ha))
    t.add(f"{prefix}/w0", (L, H * Dh), ("layers", ha), init="zeros")
    t.add(f"{prefix}/w_lora_a", (L, d, LORA_R), ("layers", "embed", None))
    t.add(f"{prefix}/w_lora_b", (L, LORA_R, H * Dh), ("layers", None, ha))
    t.add(f"{prefix}/u_bonus", (L, H, Dh), ("layers", None, None),
          init="zeros")
    t.add(f"{prefix}/ln_g", (L, H * Dh), ("layers", ha), init="ones")
    t.add(f"{prefix}/w_o", (L, H * Dh, d), ("layers", ha, "embed"))
    # channel-mix (rwkv ffn)
    t.add(f"{prefix}/cmix_k", (L, d), ("layers", "embed"), init="zeros")
    t.add(f"{prefix}/cmix_r", (L, d), ("layers", "embed"), init="zeros")
    t.add(f"{prefix}/c_wr", (L, d, d), ("layers", "embed", None))
    t.add(f"{prefix}/c_wk", (L, d, cfg.d_ff), ("layers", "embed", "ff"))
    t.add(f"{prefix}/c_wv", (L, cfg.d_ff, d), ("layers", "ff", "embed"))


def _shift(x: torch.Tensor, x_prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x: (B,S,d) -> the previous token's x; x_prev: (B,d), the last token
    before x (zeros when None)."""
    if x_prev is None:
        x_prev = x.new_zeros(x.shape[0], x.shape[2])
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def _time_mix_inputs(cfg, p, x, x_prev):
    """r, k, v, g, w of the heads whose columns ``p`` holds (H read from
    ``w_r``'s width)."""
    B, S, _d = x.shape
    Dh = cfg.resolved_head_dim
    H = p["w_r"].shape[-1] // Dh
    xs = _shift(x, x_prev)
    r = (_mix(x, xs, p["mix_r"]) @ p["w_r"]).reshape(B, S, H, Dh)
    k = (_mix(x, xs, p["mix_k"]) @ p["w_k"]).reshape(B, S, H, Dh)
    v = (_mix(x, xs, p["mix_v"]) @ p["w_v"]).reshape(B, S, H, Dh)
    g = F.silu(_mix(x, xs, p["mix_g"]) @ p["w_g"])
    xw = _mix(x, xs, p["mix_w"])
    w_raw = p["w0"] + torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(wide(w_raw))).reshape(B, S, H, Dh)
    return r, k, v, g, w


def _group_norm(y, ln_g, H, Dh, eps=1e-5):
    """Per-head normalization over Dh (population variance, as
    ``jnp.var``), float32 (`layers.wide`)."""
    B, S = y.shape[:2]
    yh = wide(y.reshape(B, S, H, Dh))
    mean = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, unbiased=False)
    yh = (yh - mean) * torch.rsqrt(var + eps)
    return yh.reshape(B, S, H * Dh) * ln_g.to(yh.dtype)


def wkv(r, k, v, w, u, state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over time, in float32 (float64 for float64 inputs,
    `layers.wide`). r, k, v, w: (B,S,H,Dh) (w in that type), u: (H,Dh);
    state: (B,H,Dk,Dv) or None (zeros); the state given is not written.
    Returns (y (B,S,H,Dv) in that type, final state)."""
    r, k, v = wide(r), wide(k), wide(v)
    B, S, H, Dh = r.shape
    S_t = (torch.zeros(B, H, Dh, Dh, dtype=r.dtype, device=r.device)
           if state is None else state.to(r.dtype).clone())
    bonus = (r * u.to(r.dtype) * k).sum(-1, keepdim=True) * v  # (B,S,H,Dv)
    # time-major copies: each step reads contiguous (B,H,Dh) slices
    rt, kt, vt, wt = (a.transpose(0, 1).contiguous() for a in (r, k, v, w))
    if torch.is_grad_enabled() and (S_t.requires_grad or any(
            a.requires_grad for a in (rt, kt, vt, wt))):
        # training: the same steps out of place, so that autograd keeps
        # every S_{t-1} its products need
        outs = []
        for t in range(S):
            outs.append(torch.matmul(rt[t].unsqueeze(-2), S_t))
            S_t = S_t * wt[t].unsqueeze(-1) + kt[t].unsqueeze(-1) \
                * vt[t].unsqueeze(-2)
        ys = torch.stack(outs)
    else:
        ys = r.new_empty(S, B, H, 1, Dh)
        for t in range(S):
            torch.matmul(rt[t].unsqueeze(-2), S_t, out=ys[t])
            S_t.mul_(wt[t].unsqueeze(-1)).addcmul_(kt[t].unsqueeze(-1),
                                                  vt[t].unsqueeze(-2))
    return ys[:, :, :, 0].transpose(0, 1) + bonus, S_t


def time_mix_heads(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                   x: torch.Tensor, state: Optional[torch.Tensor] = None,
                   x_prev: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The time mix's head bank before ``w_o``, for the heads whose
    weights ``p`` holds (``w_r``/``w_k``/``w_v``/``w_g``/``w_lora_b``
    columns, ``w0``/``ln_g`` entries and ``u_bonus`` rows of H_r heads):
    x (B,S,d) -> (the gated, group-normed y (B,S,H_r·Dh) in x's type,
    final state (B,H_r,Dk,Dv) float32, x_last (B,d)). Each head's state
    is its own, so a block of heads needs nothing of the others."""
    B, S, _d = x.shape
    r, k, v, g, w = _time_mix_inputs(cfg, p, x, x_prev)
    H, Dh = r.shape[2], r.shape[3]
    y, state = wkv(r, k, v, w, p["u_bonus"], state)
    y = _group_norm(y.reshape(B, S, H * Dh), p["ln_g"], H, Dh)
    return y.to(x.dtype) * g, state, x[:, -1]


def time_mix(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
             state: Optional[torch.Tensor] = None,
             x_prev: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (out, final state (B,H,Dk,Dv) float32, x_last (B,d))."""
    y, state, x_last = time_mix_heads(cfg, p, x, state, x_prev)
    return y @ p["w_o"], state, x_last


def channel_mix_keys(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                     x: torch.Tensor, x_prev: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The channel mix before ``c_wv``: (relu(xk @ c_wk)^2 for the ff
    columns of the ``c_wk`` given, the gate's input xr (B,S,d))."""
    xs = _shift(x, x_prev)
    xk = _mix(x, xs, p["cmix_k"])
    xr = _mix(x, xs, p["cmix_r"])
    return torch.square(F.relu(xk @ p["c_wk"])), xr


def channel_mix(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                x_prev: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    k, xr = channel_mix_keys(cfg, p, x, x_prev)
    return torch.sigmoid(xr @ p["c_wr"]) * (k @ p["c_wv"]), x[:, -1]
