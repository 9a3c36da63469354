"""Serving steps of the LM stack: the port of the serving half of
`repro.launch.steps` (`make_prefill_step`, `make_decode_step`). The
reference's sharding plans have no counterpart on one card."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import decoding


def make_prefill_step(cfg: ArchConfig, max_len: int = 0):
    """prefill_step(params, batch) -> (last logits (B,V), cache); the
    cache holds ``max(max_len, S)`` slots in its full-attention layers."""
    def prefill_step(params, batch):
        return decoding.prefill(cfg, params, batch, max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """decode_step(params, cache, tokens (B,1), step, row=None) ->
    (logits (B,1,V), cache), the cache (its batch row ``row``, every row
    if None) updated in place."""
    def decode_step(params, cache, tokens, step, row=None):
        return decoding.decode_step(cfg, params, cache, tokens, step, row)
    return decode_step
