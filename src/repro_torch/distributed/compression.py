"""Gradient compression: int8 quantization with error feedback (EF-SGD).

The port of the local half of `repro.distributed.compression`. Each leaf
is quantized with one max-abs scale (`quantize`), the quantization error
is carried to the next step as a residual (`compress_tree`), and
`ef_allreduce` with no axis dequantizes locally. Trees are the port's
nested dicts and lists of tensors; a compressed leaf is the pair
``(int8 values, float32 scale)``.

Over a named mesh axis the leaves are `distributed.meshes.ShardedTensor`s
whose pieces are each position's own gradients (partial over the axis,
as the per-device values inside the reference's ``shard_map``): each
piece is quantized with its own scale, the int8 codes are summed in
int32 over the axis's groups in mesh order, and the sum is multiplied by
the mean of the group's scales and divided by the group's size, the
reference's ``psum`` / ``pmean`` arithmetic; every position of a group
gets the same average.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed import meshes as M
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
    if M.is_placed(g):
        parts = [_compress(a, b) for a, b in zip(g.pieces, r.pieces)]
        return ([c for c, _ in parts],
                M.ShardedTensor(g.placement, g.shape, [n for _, n in parts],
                                g.partial))
    target = g.float() + r
    q, s = quantize(target)
    return (q, s), target - dequantize(q, s)


def compress_tree(grads, residual=None):
    """-> (a tree of (q, scale) leaves, the new residual tree): each leaf
    quantized after its residual is added (float32)."""
    if residual is None:
        residual = tree_map(
            lambda g: M.map_placed(
                lambda t: torch.zeros_like(t, dtype=torch.float32), g)
            if M.is_placed(g) else torch.zeros_like(g, dtype=torch.float32),
            grads)
    return _compress(grads, residual)


def decompress_tree(comp):
    """The float32 tree of a compressed one."""
    return _map_pairs(lambda qs: dequantize(*qs), comp)


def _reduce_placed(g: M.ShardedTensor, pairs, axis: str) -> M.ShardedTensor:
    """The int32 sum of the group's codes times the mean of its scales,
    over its size (module docstring), for each group of ``axis``."""
    mesh = g.mesh
    devs = mesh.device_list()
    out = [None] * mesh.size
    for grp in M._groups(mesh, (axis,)):
        dev = devs[grp[0]]
        tot, ssum = None, None
        for j in grp:                                   # mesh order
            q, s = pairs[j]
            qj, sj = q.to(dev, torch.int32), s.to(dev)
            tot = qj if tot is None else tot + qj
            ssum = sj if ssum is None else ssum + sj
        n = float(len(grp))
        avg = tot.float() * (ssum / n) / n
        for j in grp:
            out[j] = avg.to(devs[j], copy=True)
    return M.ShardedTensor(g.placement, g.shape, out,
                           tuple(a for a in g.partial if a != axis))


def ef_allreduce(grads, residual, axis_name: Optional[str] = None):
    """Error-feedback int8 all-reduce over the mesh axis ``axis_name``
    (None: local, one card); returns (the averaged float32 grads, the new
    residual). Over an axis the leaves are placed (module docstring)."""
    comp, new_res = compress_tree(grads, residual)
    if axis_name is None:
        return decompress_tree(comp), new_res

    def walk(g, c):
        if M.is_placed(g):
            return _reduce_placed(g, c, axis_name)
        if isinstance(g, dict):
            return {k: walk(g[k], c[k]) for k in g}
        if isinstance(g, (list, tuple)):
            return type(g)(walk(x, y) for x, y in zip(g, c))
        raise TypeError(f"ef_allreduce over {axis_name!r} takes placed "
                        f"leaves (meshes.ShardedTensor), got {type(g)}")
    return walk(grads, comp), new_res
