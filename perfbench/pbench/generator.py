"""The one traffic generator: a mix's parameters (a file under
``traffic/``) and a configuration give each call's shape and batch,
drawn on the device from the run's seed and the call's index, so that
the same call can be drawn again for the reference.

A mix lists its call ``shapes``, each ``batch`` prompts of ``length``
positions, with ``images``: the merged-patch grids (rows, columns) of
the images that open each prompt. Call i takes shape
``order(i)``: every block of ``len(shapes)`` calls holds each shape once,
in an order drawn from the seed for that block, so that every seed runs
the same work in another order. Warm-up calls (negative indices) take
the shapes in their listed order.

A VLM configuration's calls put one stub vision embedding a grid cell,
N(0, ``vision_std``) in the compute type, in place of the first
positions, with M-RoPE positions by Qwen2-VL's rule: each image's cells
at (t, h, w) = start + (0, row, column), the next image or the text
starting at the previous image's start plus the larger side of its grid,
the text on all three columns one position a token. Token ids are
uniform over the vocabulary.
"""
from __future__ import annotations

import random
from typing import Dict, List, Tuple

import torch

from pbench import weights


def shape_of(mix: dict, seed: int, index: int) -> dict:
    """Call ``index``'s shape."""
    n = len(mix["shapes"])
    if index < 0:
        return mix["shapes"][(-1 - index) % n]
    block, at = divmod(index, n)
    order = list(range(n))
    random.Random(weights.derive(seed, "order", block)).shuffle(order)
    return mix["shapes"][order[at]]


def vision_tokens(shape: dict) -> int:
    return sum(h * w for h, w in shape.get("images", ()))


def mrope_positions(batch: int, length: int, grids: List[Tuple[int, int]],
                    device) -> torch.Tensor:
    """(batch, length, 3) int32 positions of prompts that open with the
    images of ``grids`` and go on with text."""
    pos = torch.empty((length, 3), dtype=torch.int32, device=device)
    start = at = 0
    for h, w in grids:
        i = torch.arange(h * w, dtype=torch.int32, device=device)
        pos[at:at + h * w, 0] = start
        pos[at:at + h * w, 1] = start + i // w
        pos[at:at + h * w, 2] = start + i % w
        start += max(h, w)
        at += h * w
    if at >= length:
        raise ValueError(f"{at} vision positions leave no text in a "
                         f"prompt of {length}")
    text = torch.arange(start, start + length - at, dtype=torch.int32,
                        device=device)
    pos[at:] = text[:, None]
    return pos[None].expand(batch, length, 3).contiguous()


def make_batch(conf: dict, mix: dict, seed: int, index: int,
               device) -> Dict[str, torch.Tensor]:
    """Call ``index``'s batch."""
    device = torch.device(device)
    shape = shape_of(mix, seed, index)
    g = weights.generator(device, seed, "batch", index)
    B, S, V = shape["batch"], shape["length"], conf["vocab_size"]
    out = {"tokens": torch.randint(0, V, (B, S), generator=g, device=device,
                                   dtype=torch.int32)}
    nv = vision_tokens(shape)
    if nv:
        if not conf.get("n_vision_tokens"):
            raise ValueError(f"{conf['name']} takes no images")
        dt = getattr(torch, conf["dtype"])
        out["vision_embeds"] = torch.randn(
            (B, nv, conf["d_model"]), generator=g, device=device,
            dtype=dt).mul_(mix["vision_std"])
        if conf.get("mrope_sections"):
            out["positions"] = mrope_positions(
                B, S, [tuple(x) for x in shape["images"]], device)
    return out


def tokens(shape: dict) -> int:
    return shape["batch"] * shape["length"]
