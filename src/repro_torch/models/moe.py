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

Over a mesh (`distributed.spmd`) a data position routes its own tokens
(`choose`), and `place` then ranks each assignment in the whole batch's
order: the counts of the data positions before it are added to its
places, and C is the whole batch's. `expert_partial` runs one model
shard's experts on the assignments kept for them and returns their
gated sum in float32, for the sum over the shards.

The router product follows ``torch.backends.cuda.matmul.allow_tf32``,
off by default and in `chip_smoke.py`. Each stage runs under a span
(`SPANS`, `repro_torch.spans`), which a profiler reads to split a call's
device time; no profiler, no cost beyond a flag check.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import ParamTable, activation
from repro_torch.spans import span

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


class Choice(NamedTuple):
    """The router's choice for T tokens, before capacity."""
    probs: torch.Tensor    # (T, E) float32 softmax of the router logits
    idx: torch.Tensor      # (T, k) int64 experts, largest gate first
    gates: torch.Tensor    # (T, k) float32, renormalized to sum 1
    seen: torch.Tensor     # (E, T*k) int32 per expert, inclusive count of
    #                        its assignments up to each in the flattening

    @property
    def counts(self) -> torch.Tensor:
        """(E,) int32 assignments to each expert."""
        return self.seen[:, -1]


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


def choose(cfg: ArchConfig, router: torch.Tensor, xt: torch.Tensor
           ) -> Choice:
    """The experts and gates of tokens ``xt`` (T, d) through ``router``
    (d, E), and each expert's running count of its assignments.

    An assignment's place is the count of assignments to its expert
    before it in the flattening, as the reference's cumulative sum of
    one-hot rows over (T*k, E) gives it. Here the hits are laid out
    expert-major, (E, T*k), and summed in one scan of the flat tensor,
    each expert's row then less the sum of the rows before it: a
    scan along the outer axis of (T*k, E) takes 13 ms at T*k = 49,152 on
    an H100, this one microseconds; integers, so the places are equal."""
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gates, idx = top_k(probs, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = idx.reshape(-1)
    hits = (flat_e == torch.arange(E, device=flat_e.device)[:, None]).to(
        torch.int32)                                      # (E, T*k)
    seen = hits.view(-1).cumsum(0, dtype=torch.int32).view(E, -1)
    seen = seen - (seen[:, :1] - hits[:, :1])   # per expert, inclusive
    return Choice(probs, idx, gates, seen)


def place(ch: Choice, C: int, before: Optional[torch.Tensor] = None
          ) -> Routing:
    """The places of ``ch``'s assignments among C per expert: the count of
    assignments to its expert before it, plus ``before`` (E,) where the
    tokens follow others in the batch's order (a mesh's earlier data
    positions). Assignments at places >= C are dropped."""
    flat_e = ch.idx.reshape(-1)
    pos = ch.seen.gather(0, flat_e[None]).squeeze(0).long() - 1
    if before is not None:
        pos = pos + before.long()[flat_e]
    keep = pos < C
    dest = flat_e * C + pos.clamp_max(C - 1)
    return Routing(ch.probs, ch.idx, ch.gates, ch.counts, pos, keep, dest,
                   C)


def route(cfg: ArchConfig, router: torch.Tensor, xt: torch.Tensor,
          deterministic_capacity: int = 0) -> Routing:
    """The dispatch of tokens ``xt`` (T, d) through ``router`` (d, E):
    `choose`, then `place` among `capacity` places per expert."""
    return place(choose(cfg, router, xt),
                 capacity(cfg, xt.shape[0], deterministic_capacity))


def moe_ffn(cfg: ArchConfig, p: Dict[str, Any], x: torch.Tensor,
            deterministic_capacity: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> ((B,S,d), aux). ``p`` holds one layer's slices. aux
    is the Switch-style load-balancing loss, float32."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    with span("moe_router"):
        r = route(cfg, p["router"], xt, deterministic_capacity)
    y = expert_partial(cfg, p, xt, r, 0, E).to(x.dtype)
    me = r.probs.mean(dim=0)
    ce = r.counts.float() / (T * k)
    aux = E * torch.sum(me * ce)
    return y.view(B, S, d), aux


def expert_partial(cfg: ArchConfig, p: Dict[str, Any], xt: torch.Tensor,
                   r: Routing, e0: int, e1: int) -> torch.Tensor:
    """Experts [e0, e1) of one layer on the tokens ``xt`` (T, d) routed by
    ``r``: their gated outputs summed over each token's k assignments,
    (T, d) float32. ``p`` holds those experts' slices ((e1 - e0, d, f)
    and (e1 - e0, f, d)). Kept assignments go to their own rows of a
    buffer of C places per expert, the others to a spare row past it;
    each product and gated output is rounded to x's type, and the sum
    over assignments is float32, so that a sum over the shards that own
    the other experts rounds once (`moe_ffn` rounds the sum over all E)."""
    T, d = xt.shape
    k = cfg.top_k
    C = r.capacity
    n = (e1 - e0) * C
    flat_e = r.idx.reshape(-1)
    with span("moe_dispatch"):
        local = r.keep & (flat_e >= e0) & (flat_e < e1)
        rows = torch.where(local, r.dest - e0 * C, n)
        buf = xt.new_zeros((n + 1, d))
        buf[rows] = xt.repeat_interleave(k, dim=0)
        xe = buf[:n].view(e1 - e0, C, d)
    with span("moe_experts"):
        act = activation(cfg.act)
        h = act(torch.bmm(xe, p["w_gate"].to(xt.dtype))) * torch.bmm(
            xe, p["w_up"].to(xt.dtype))
        ye = torch.bmm(h, p["w_down"].to(xt.dtype)).view(n, d)
    with span("moe_combine"):
        w = local.to(xt.dtype) * r.gates.reshape(-1).to(xt.dtype)
        y = ye[torch.where(local, rows, 0)] * w[:, None]
        return y.float().view(T, k, d).sum(dim=1)
