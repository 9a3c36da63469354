"""Weights and seeds: every leaf drawn from the run's seed on the device,
one generator and one call a leaf, in the type it is used in, so that
any leaf can be drawn again alike (the reference's copy, the starting
point of a training comparison)."""
from __future__ import annotations

import hashlib
from typing import Dict

import torch


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for one purpose of a run's seed."""
    text = repr((int(seed),) + tuple(parts)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device: torch.device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *parts))


def leaf(spec, path: str, seed: int, device, dtype) -> torch.Tensor:
    """One declared leaf: (shape, init, scale) with init "normal",
    "zeros" or "ones"."""
    shape, init, scale = spec
    device = torch.device(device)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init != "normal":
        raise ValueError(f"{path}: unknown initializer {init!r}")
    g = generator(device, seed, "weights", path)
    return torch.randn(shape, generator=g, dtype=dtype,
                       device=device).mul_(scale)


def make(declared: Dict[str, tuple], seed: int, device,
         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every declared leaf, by path."""
    return {path: leaf(spec, path, seed, device, dtype)
            for path, spec in sorted(declared.items())}


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """The leaves by path as nested dicts ("blocks/attn/wq" ->
    tree["blocks"]["attn"]["wq"]), the same tensors."""
    tree: dict = {}
    for path, t in flat.items():
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = t
    return tree


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The inverse of `nest`."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}/{k}" if prefix else k))
    return out
