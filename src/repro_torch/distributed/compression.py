"""Gradient compression: int8 quantization with error feedback (EF-SGD).

The port of the local half of `repro.distributed.compression`. Each leaf
is quantized with one max-abs scale (`quantize`), the quantization error
is carried to the next step as a residual (`compress_tree`), and
`ef_allreduce` with no axis dequantizes locally. Trees are the port's
nested dicts and lists of tensors; a compressed leaf is the pair
``(int8 values, float32 scale)``.

The all-reduce over a named axis (the reference's int32 ``psum`` under
``shard_map``) is multi-card work: ROADMAP queue 1, the multi-card item.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.layers import tree_map


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 round(g / scale) clipped to +-127, float32 scale =
    max(max|g|, 1e-12) / 127)."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _is_pair(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], torch.Tensor)
            and x[0].dtype == torch.int8)


def _map_pairs(fn, comp):
    if _is_pair(comp):
        return fn(comp)
    if isinstance(comp, dict):
        return {k: _map_pairs(fn, v) for k, v in comp.items()}
    return type(comp)(_map_pairs(fn, v) for v in comp)


def _compress(g, r):
    """(compressed tree, new residual tree) of one subtree."""
    if isinstance(g, dict):
        parts = {k: _compress(g[k], r[k]) for k in g}
        return ({k: c for k, (c, _) in parts.items()},
                {k: n for k, (_, n) in parts.items()})
    if isinstance(g, (list, tuple)):
        parts = [_compress(x, y) for x, y in zip(g, r)]
        return (type(g)(c for c, _ in parts), type(g)(n for _, n in parts))
    target = g.float() + r
    q, s = quantize(target)
    return (q, s), target - dequantize(q, s)


def compress_tree(grads, residual=None):
    """-> (a tree of (q, scale) leaves, the new residual tree): each leaf
    quantized after its residual is added (float32)."""
    if residual is None:
        residual = tree_map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
    return _compress(grads, residual)


def decompress_tree(comp):
    """The float32 tree of a compressed one."""
    return _map_pairs(lambda qs: dequantize(*qs), comp)


def ef_allreduce(grads, residual, axis_name: Optional[str] = None):
    """Error-feedback int8 reduction; returns (the dequantized float32
    grads, the new residual). With no axis (one card) it is local; a named
    axis raises."""
    if axis_name is not None:
        raise NotImplementedError(
            f"ef_allreduce over axis {axis_name!r}: the all-reduce across "
            f"cards is not ported (ROADMAP.md, queue 1, the multi-card "
            f"item); pass axis_name=None on one card")
    comp, new_res = compress_tree(grads, residual)
    return decompress_tree(comp), new_res
