"""Top-k mixture-of-experts with scatter-based (GShard-capacity) dispatch.

The port of `repro.models.moe`. Tokens are scattered into an (E, C, d)
buffer of C places per expert, the experts' SwiGLU products run as three
batched matrix products over that buffer, and the outputs are gathered
back and summed over the k assignments, weighted by the renormalized
gates. The dispatch is the reference's to the bit: the router product
and softmax in float32, the top k with the lower expert first on ties,
each assignment's place from a cumulative count over the token-major,
k-minor flattening, and C places per expert (`capacity`); assignments
past an expert's C places are dropped (weighted 0).

Two choices keep the result independent of the device's order of work:
`top_k` sorts stably (``torch.topk`` orders ties arbitrarily), and the
scatter writes each kept assignment to its own row and every dropped one
to a spare row past the buffer (no atomics, no host sync), where the
reference adds zeros at ``e*C + C-1``.

The router product follows ``torch.backends.cuda.matmul.allow_tf32``,
off by default and in `chip_smoke.py`. Each stage runs under a
``torch.profiler.record_function`` span (`SPANS`), which a profiler reads
to split a call's device time; no profiler, no cost beyond the span's
enter and exit.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import ParamTable, activation

SPANS = ("moe_router", "moe_dispatch", "moe_experts", "moe_combine")


def declare_moe(t: ParamTable, prefix: str, cfg: ArchConfig, n_layers: int):
    d, E, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    L = n_layers
    t.add(f"{prefix}/router", (L, d, E), ("layers", "embed", None))
    t.add(f"{prefix}/w_gate", (L, E, d, f),
          ("layers", "experts", "embed", "ff"))
    t.add(f"{prefix}/w_up", (L, E, d, f),
          ("layers", "experts", "embed", "ff"))
    t.add(f"{prefix}/w_down", (L, E, f, d),
          ("layers", "experts", "ff", "embed"))


def capacity(cfg: ArchConfig, n_tokens: int,
             deterministic_capacity: int = 0) -> int:
    """Places per expert for ``n_tokens`` tokens (the whole batch's)."""
    return deterministic_capacity or max(
        int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts), 1)


def top_k(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row, largest first, the lower index
    first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing(NamedTuple):
    """One call's dispatch over T tokens and k assignments each."""
    probs: torch.Tensor    # (T, E) float32 softmax of the router logits
    idx: torch.Tensor      # (T, k) int64 experts, largest gate first
    gates: torch.Tensor    # (T, k) float32, renormalized to sum 1
    counts: torch.Tensor   # (E,) int32 assignments to each expert
    pos: torch.Tensor      # (T*k,) int64 place of each assignment
    keep: torch.Tensor     # (T*k,) bool: pos < capacity
    dest: torch.Tensor     # (T*k,) int64 row of the (E*C, d) buffer
    capacity: int


def route(cfg: ArchConfig, router: torch.Tensor, xt: torch.Tensor,
          deterministic_capacity: int = 0) -> Routing:
    """The dispatch of tokens ``xt`` (T, d) through ``router`` (d, E).

    An assignment's place is the count of assignments to its expert
    before it in the flattening, as the reference's cumulative sum of
    one-hot rows over (T*k, E) gives it. Here the hits are laid out
    expert-major, (E, T*k), and summed in one scan of the flat tensor,
    each expert's row then less the sum of the rows before it: a
    scan along the outer axis of (T*k, E) takes 13 ms at T*k = 49,152 on
    an H100, this one microseconds; integers, so the places are equal."""
    T = xt.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, T, deterministic_capacity)
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gates, idx = top_k(probs, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = idx.reshape(-1)
    hits = (flat_e == torch.arange(E, device=flat_e.device)[:, None]).to(
        torch.int32)                                      # (E, T*k)
    seen = hits.view(-1).cumsum(0, dtype=torch.int32).view(E, -1)
    seen = seen - (seen[:, :1] - hits[:, :1])   # per expert, inclusive
    pos = seen.gather(0, flat_e[None]).squeeze(0).long() - 1
    keep = pos < C
    dest = flat_e * C + pos.clamp_max(C - 1)
    return Routing(probs, idx, gates, seen[:, -1], pos, keep, dest, C)


def moe_ffn(cfg: ArchConfig, p: Dict[str, Any], x: torch.Tensor,
            deterministic_capacity: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> ((B,S,d), aux). ``p`` holds one layer's slices. aux
    is the Switch-style load-balancing loss, float32."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    with record_function("moe_router"):
        r = route(cfg, p["router"], xt, deterministic_capacity)
    C = r.capacity
    with record_function("moe_dispatch"):
        # kept assignments to their own rows, dropped ones to row E*C
        rows = torch.where(r.keep, r.dest, E * C)
        buf = x.new_zeros((E * C + 1, d))
        buf[rows] = xt.repeat_interleave(k, dim=0)
        xe = buf[:E * C].view(E, C, d)
    with record_function("moe_experts"):
        act = activation(cfg.act)
        h = act(torch.bmm(xe, p["w_gate"].to(x.dtype))) * torch.bmm(
            xe, p["w_up"].to(x.dtype))
        ye = torch.bmm(h, p["w_down"].to(x.dtype)).view(E * C, d)
    with record_function("moe_combine"):
        w = r.keep.to(x.dtype) * r.gates.reshape(-1).to(x.dtype)
        y = (ye[r.dest] * w[:, None]).view(T, k, d).sum(dim=1)
    me = r.probs.mean(dim=0)
    ce = r.counts.float() / (T * k)
    aux = E * torch.sum(me * ce)
    return y.view(B, S, d), aux
