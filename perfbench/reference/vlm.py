"""Plain float32 reference of the VLM family (Qwen2-VL, arXiv:2409.12191):
the language model over stub vision embeddings.

A decoder of pre-norm blocks: x + attention(rms_norm(x)), then
x + SwiGLU(rms_norm(x)); grouped-query attention with q, k and v biases,
causal, rotated by M-RoPE (frequency bands of 16, 24 and 24 pairs turned
by the temporal, height and width position columns); a final rms_norm
and an untied head. The first positions take the vision embeddings in
place of the token embeddings, as many as the batch brings. Departure from the
published model: the vision tower is not run; its output is an input.

`declare` names every weight with its shape and initializer (the
benchmark draws them from the seed); `prefill` returns the last
position's logits and every layer's keys and values. Weights are read
one layer at a time in float32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from pbench import plain


def declare(conf: dict) -> Dict[str, Tuple[Tuple[int, ...], str, float]]:
    """path -> (shape, init, scale): "normal" draws N(0, 1) x scale."""
    d, L, V = conf["d_model"], conf["n_layers"], conf["vocab_size"]
    H, KV, D, f = (conf["n_heads"], conf["n_kv_heads"], conf["head_dim"],
                   conf["d_ff"])
    out = {"embed/tokens": ((V, d), "normal", 0.02),
           "head/w": ((d, V), "normal", d ** -0.5),
           "final_norm": ((d,), "ones", 1.0),
           "blocks/norm1": ((L, d), "ones", 1.0),
           "blocks/norm2": ((L, d), "ones", 1.0),
           "blocks/attn/wq": ((L, d, H * D), "normal", d ** -0.5),
           "blocks/attn/wk": ((L, d, KV * D), "normal", d ** -0.5),
           "blocks/attn/wv": ((L, d, KV * D), "normal", d ** -0.5),
           "blocks/attn/wo": ((L, H * D, d), "normal", (H * D) ** -0.5),
           "blocks/mlp/w_gate": ((L, d, f), "normal", d ** -0.5),
           "blocks/mlp/w_up": ((L, d, f), "normal", d ** -0.5),
           "blocks/mlp/w_down": ((L, f, d), "normal", f ** -0.5)}
    if conf.get("qkv_bias"):
        out["blocks/attn/bq"] = ((L, H * D), "normal", 0.02)
        out["blocks/attn/bk"] = ((L, KV * D), "normal", 0.02)
        out["blocks/attn/bv"] = ((L, KV * D), "normal", 0.02)
    return out


def embed(conf: dict, w: dict, batch: dict) -> torch.Tensor:
    x = w["embed/tokens"][batch["tokens"].long()].float()
    ve = batch.get("vision_embeds")
    if ve is not None:
        x[:, :ve.shape[1]] = ve.float()
    return x


def _block(conf, p, x, positions, precision):
    nx = plain.rms_norm(x, p["norm1"], conf["norm_eps"])
    a, k, v = plain.attention_branch(conf, p, nx, positions, precision)
    x = x + a
    nx = plain.rms_norm(x, p["norm2"], conf["norm_eps"])
    x = x + plain.mlp(nx, p["mlp/w_gate"], p["mlp/w_up"], p["mlp/w_down"],
                      precision)
    return x, k, v


def hidden(conf: dict, w: dict, batch: dict, precision: str = "float32",
           keep_cache: bool = False):
    """Final-normed hidden states (B,S,d) and, with ``keep_cache``, each
    layer's (k, v)."""
    x = embed(conf, w, batch)
    cache = {"k": [], "v": []}
    for p in plain.layers(w):
        x, k, v = _block(conf, p, x, batch["positions"], precision)
        if keep_cache:
            cache["k"].append(k)
            cache["v"].append(v)
    return plain.rms_norm(x, w["final_norm"], conf["norm_eps"]), cache


@torch.no_grad()
def prefill(conf: dict, w: dict, batch: dict, precision: str = "float32"):
    """(last position's logits (B,V), {"k": [L x (B,S,KV,D)], "v": ...})."""
    h, cache = hidden(conf, w, batch, precision, keep_cache=True)
    return plain.matmul(h[:, -1], w["head/w"], precision), cache

