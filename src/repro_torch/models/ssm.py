"""Selective SSM (mamba-style) head bank of the Hymba hybrid blocks.

The port of `repro.models.ssm`. State: (B, H, Dh, N). Per step t (decay
a_t in (0,1), data-dependent):
    S_t = a_t * S_{t-1} + dt_t * x_t (outer) B_t
    y_t = S_t @ C_t + D_h * x_t
Prefill writes the recurrence as one diagonal scan over T = S steps and
D = B*H*Dh*N channels and calls `kernels.ops.ssm_scan` once per layer
(the CUDA kernel on a card); the decay is passed compact, one value per
(batch, head) shared by that head's Dh*N channels. Decode is a single
recurrence step in plain PyTorch.

`ssm_heads` and `ssm_decode_heads` are the head bank alone: the gated y
(B, S, H_r*Dh) of the heads whose weights they are given (H_r read from
``in_proj``'s width), without the ``out_proj`` product, so that a mesh
(`distributed.spmd`) can run each model shard's heads and make
``out_proj`` a row-parallel product; `ssm_scan` and `ssm_decode_step`
add that product.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamTable, head_axis


def declare_ssm(t: ParamTable, prefix: str, cfg: ArchConfig, n_layers: int):
    d, H = cfg.d_model, cfg.n_heads
    Dh = cfg.resolved_head_dim
    N, L = cfg.ssm_state, n_layers
    ha = head_axis(H)
    t.add(f"{prefix}/in_proj", (L, d, H * Dh), ("layers", "embed", ha))
    t.add(f"{prefix}/gate_proj", (L, d, H * Dh), ("layers", "embed", ha))
    t.add(f"{prefix}/bc_proj", (L, d, 2 * N), ("layers", "embed", None))
    t.add(f"{prefix}/dt_proj", (L, d, H), ("layers", "embed", None))
    t.add(f"{prefix}/a_log", (L, H), ("layers", None), init="zeros")
    t.add(f"{prefix}/d_skip", (L, H), ("layers", None), init="ones")
    t.add(f"{prefix}/out_proj", (L, H * Dh, d), ("layers", ha, "embed"))


def _ssm_inputs(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                x: torch.Tensor):
    B, S, d = x.shape
    Dh, N = cfg.resolved_head_dim, cfg.ssm_state
    H = p["in_proj"].shape[-1] // Dh
    xh = (x @ p["in_proj"]).reshape(B, S, H, Dh)
    z = (x @ p["gate_proj"]).reshape(B, S, H, Dh)
    bc = x @ p["bc_proj"]
    Bmat, Cmat = bc[..., :N], bc[..., N:]                 # (B,S,N)
    dt = F.softplus(x @ p["dt_proj"])                     # (B,S,H)
    a = torch.exp(-torch.exp(p["a_log"].float())[None, None]
                  * dt.float())                           # (B,S,H)
    return xh, z, Bmat, Cmat, dt, a


def ssm_heads(cfg: ArchConfig, p: Dict[str, torch.Tensor],
              x: torch.Tensor, state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The head bank of the weights ``p`` (H_r heads): x (B,S,d) -> (the
    gated y (B,S,H_r*Dh) in x's type, final_state (B,H_r,Dh,N)
    float32)."""
    B, S, d = x.shape
    xh, z, Bmat, Cmat, dt, a = _ssm_inputs(cfg, p, x)
    H, Dh, N = xh.shape[2], cfg.resolved_head_dim, cfg.ssm_state
    if state is None:
        state = torch.zeros((B, H, Dh, N), dtype=torch.float32,
                            device=x.device)
    # time-major: b_t[b,h,d,n] = (dt*x)[b,t,h,d] * B[b,t,n], rounded in x's
    # type as the reference computes it, then float32
    u = (dt[..., None] * xh).transpose(0, 1).contiguous()  # (S,B,H,Dh)
    bt = Bmat.transpose(0, 1).contiguous()                 # (S,B,N)
    contrib = u[..., None] * bt[:, :, None, None, :]
    b_seq = contrib.float().reshape(S, B * H * Dh * N)
    a_seq = a.transpose(0, 1).reshape(S, B * H).contiguous()
    ys, y_final = ops.ssm_scan(a_seq, b_seq,
                               state.reshape(-1).float().contiguous())
    del contrib, b_seq
    # y_t = S_t @ C_t for every step: (S,B,H*Dh,N) @ (S,B,N,1)
    y = torch.matmul(ys.view(S, B, H * Dh, N),
                     Cmat.transpose(0, 1).float()[..., None])
    del ys
    y = y.view(S, B, H, Dh).transpose(0, 1).to(x.dtype)  # (B,S,H,Dh)
    y = y + p["d_skip"][None, None, :, None] * xh
    y = y * F.silu(z)
    return y.reshape(B, S, H * Dh), y_final.view(B, H, Dh, N)


def ssm_scan(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
             state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (y: (B,S,d), final_state: (B,H,Dh,N) float32)."""
    y, final = ssm_heads(cfg, p, x, state)
    return y @ p["out_proj"], final


def ssm_decode_heads(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                     x: torch.Tensor, state: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the head bank of ``p`` (H_r heads): x (B,1,d), state
    (B,H_r,Dh,N) -> (the gated y (B,1,H_r*Dh), state')."""
    B = x.shape[0]
    xh, z, Bmat, Cmat, dt, a = _ssm_inputs(cfg, p, x)
    H, Dh = xh.shape[2], cfg.resolved_head_dim
    contrib = (dt[:, 0, :, None] * xh[:, 0])[..., None] * \
        Bmat[:, 0, None, None, :]
    state = a[:, 0, :, None, None] * state + contrib.float()
    y = torch.einsum("bhdn,bn->bhd", state, Cmat[:, 0].float())
    y = y.to(x.dtype) + p["d_skip"][None, :, None] * xh[:, 0]
    return (y * F.silu(z[:, 0])).reshape(B, 1, H * Dh), state


def ssm_decode_step(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                    x: torch.Tensor, state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,1,d); state: (B,H,Dh,N) -> (y: (B,1,d), state')."""
    y, state = ssm_decode_heads(cfg, p, x, state)
    return y @ p["out_proj"], state
