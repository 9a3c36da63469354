"""AdamW with decoupled weight decay and global-norm clipping.

The port of `repro.optim.adamw`. Parameters, gradients and moments are
trees of tensors (nested dicts, the layout of `models.transformer`'s
parameters); the moments are float32 whatever the parameters' type.
`update` writes the parameters and the moments IN PLACE under
``torch.no_grad()`` (the reference returns new trees; here that would
hold two copies of a 1.4 B-parameter model's state) and returns them.
Every scalar (the step, the learning rate, the bias corrections) stays
a tensor on the parameters' device, computed in float32 as the reference
computes it, so a step never waits for the host. The leaves may lie on
several devices (a mesh step passes its pieces): each leaf's update takes
the step's scalars on its own device. The update runs under a span
(`SPAN`, `repro_torch.spans`), which a profiler reads to split a step's
device time.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.layers import tree_leaves as leaves
from repro_torch.models.layers import tree_map
from repro_torch.spans import span

SPAN = "adamw_update"


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    m: Any
    v: Any


def init(params) -> AdamWState:
    """Step 0 and zero float32 moments shaped like ``params``, on their
    device."""
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v=tree_map(torch.clone, zeros))


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """lr(step): linear warmup to ``base_lr`` over ``warmup`` steps, then a
    half cosine to 0 at ``total``; float32 arithmetic on a step tensor."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(grads) -> torch.Tensor:
    """The float32 L2 norm of every leaf together; the leaves' squared
    sums are added in the reference's leaf order."""
    flat = leaves(grads)
    total = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    for g in flat:
        total = total + g.float().square().sum()
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-6), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads x min(1, max_norm / max(norm, 1e-6)) in float32, the global
    norm)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


def update(grads, state: AdamWState, params, lr_fn: Callable,
           b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
           max_grad_norm=1.0, grad_norm: Optional[torch.Tensor] = None
           ) -> Tuple[Any, AdamWState, Dict]:
    """One AdamW step: clip (`clip_by_global_norm`, one leaf at a time),
    moments, bias-corrected update with decoupled decay. Writes
    ``params``, ``state.m`` and ``state.v`` in place and returns (params,
    new state, {"grad_norm", "lr"}). ``grad_norm`` is the gradients'
    global norm where the caller has it (a mesh step's pieces hold
    replicated blocks more than once, so it computes the norm itself:
    `distributed.meshes.global_norm`); else `global_norm` of ``grads``."""
    with torch.no_grad(), span(SPAN):
        gnorm = global_norm(grads) if grad_norm is None else grad_norm
        scale = _clip_scale(gnorm, max_grad_norm)
        step = state.step + 1
        lr = lr_fn(step)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32,
                               device=stepf.device) ** stepf
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32,
                               device=stepf.device) ** stepf
        consts = {step.device: (scale, bc1, bc2, lr)}
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.m), leaves(state.v)):
            if p.device not in consts:
                consts[p.device] = tuple(t.to(p.device)
                                         for t in (scale, bc1, bc2, lr))
            sc, c1, c2, lr_ = consts[p.device]
            g = g.float() * sc             # clipped, one leaf at a time
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.square().mul_(1 - b2))
            u = (m / c1).div_((v / c2).sqrt_().add_(eps))
            p32 = p.float()
            u.add_(weight_decay * p32)
            p.copy_(p32 - lr_ * u)
    return params, AdamWState(step, state.m, state.v), {
        "grad_norm": gnorm, "lr": lr}
