"""KV-cache / recurrent-state management and single-token decode steps.

The port of `repro.models.decoding` for every LM family.
Cache layouts (W = ring-buffer width = min(seq_len, swa_window or inf)):
 - dense/vlm/moe : {"k": (L,B,W,KV,D) bf16, "v": ..., "pos": (B,W) int32};
                   with ``kv_int8`` k and v are int8 beside "k_scale" and
                   "v_scale" (L,B,W,KV,1) bf16, one absmax / 127 scale per
                   (slot, head) (`_quantize_kv`)
 - whisper       : + {"xk": (L,B,Se,KV,D) bf16, "xv": ...}, the cross-
                   attention keys and values of the encoder's output
 - rwkv6         : {"state": (L,B,H,Dk,Dv) float32, "x_tm"/"x_cm": (L,B,d)
                   bf16}, the last token's inputs of the two token shifts
 - hymba(hybrid) : {"layers": per-layer {"k", "v": (B,Wi,KV,D) bf16,
                   "pos": (B,Wi)} (SWA layers Wi = window, global layers
                   Wi = seq_len), "ssm": (L,B,H,Dh,N) float32}
Decode steps update the cache IN PLACE (the reference returns a new one;
here that would copy every layer's cache per token) and return it with
the logits: (params, cache, tokens, step) -> (logits, cache). A step may
name the one batch row whose cache it writes (``row``): a server that
steps one slot of a shared batch leaves the other slots' rows as they
were, and `clear_row` empties a slot's row for a new request.
The int8 KV cache (``kv_int8``, the stacked families only: dense, VLM,
MoE and Whisper's decoder self-attention) quantizes each new token's k
and v as it is written and dequantizes the layer's whole cache to bf16
for attention; the hybrid and RWKV caches have no int8 form, as in the
reference. A prefill returns a bf16 cache.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import DeviceLike
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_rope, fdot, rms_norm,
                                      rope_angles, sinusoidal_at)
from repro_torch.models.transformer import (_mlp, _project_qkv,
                                            cast_params, head_weight,
                                            is_global_layer, layer_params,
                                            run_blocks, rwkv_block_fwd)
from repro_torch.spans import span


def _cache_width(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.swa_window and not cfg.global_attn_every:
        return min(cfg.swa_window, seq_len)
    return seq_len


def has_int8_cache(cfg: ArchConfig) -> bool:
    """Whether ``cfg``'s cache has an int8 form: the stacked families'
    has, the hybrid's and RWKV's have not."""
    return not (cfg.attn_free or cfg.family == "hybrid")


def _check_int8(cfg: ArchConfig, kv_int8: bool) -> None:
    if kv_int8 and not has_int8_cache(cfg):
        raise ValueError(f"{cfg.name}: the int8 KV cache is for the "
                         f"stacked families (dense, VLM, MoE, Whisper's "
                         f"decoder); the {cfg.family} cache has no int8 "
                         f"form")


def cache_spec(cfg: ArchConfig, shape: ShapeConfig,
               kv_int8: bool = False) -> Dict[str, Any]:
    """(shape, dtype) of every cache leaf: bf16 KV (int8 with bf16
    per-(slot, head) scales under ``kv_int8``), float32 recurrent
    state."""
    _check_int8(cfg, kv_int8)
    B, S = shape.global_batch, shape.seq_len
    L, KV, D = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    bf16 = torch.bfloat16
    if cfg.attn_free:
        return {"state": ((L, B, cfg.n_heads, D, D), torch.float32),
                "x_tm": ((L, B, cfg.d_model), bf16),
                "x_cm": ((L, B, cfg.d_model), bf16)}
    if cfg.family == "hybrid":
        W = min(cfg.swa_window, S)
        layers = []
        for i in range(L):
            wi = S if is_global_layer(cfg, i) else W
            layers.append({"k": ((B, wi, KV, D), bf16),
                           "v": ((B, wi, KV, D), bf16),
                           "pos": ((B, wi), torch.int32)})
        return {"layers": layers,
                "ssm": ((L, B, cfg.n_heads, D, cfg.ssm_state),
                        torch.float32)}
    W = _cache_width(cfg, S)
    kv_dt = torch.int8 if kv_int8 else bf16
    spec = {"k": ((L, B, W, KV, D), kv_dt), "v": ((L, B, W, KV, D), kv_dt),
            "pos": ((B, W), torch.int32)}
    if kv_int8:
        spec["k_scale"] = ((L, B, W, KV, 1), bf16)
        spec["v_scale"] = ((L, B, W, KV, 1), bf16)
    if cfg.enc_dec:
        spec["xk"] = ((L, B, cfg.enc_len, KV, D), bf16)
        spec["xv"] = ((L, B, cfg.enc_len, KV, D), bf16)
    return spec


def init_cache(cfg: ArchConfig, shape: ShapeConfig,
               device: DeviceLike = None, kv_int8: bool = False
               ) -> Dict[str, Any]:
    """An empty cache on ``device`` (the card unless it says otherwise):
    zeros, and position -1 in every slot."""
    device = device_lib.resolve(device)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        if isinstance(spec, list):
            return [make(v) for v in spec]
        shp, dt = spec
        if dt == torch.int32:
            return torch.full(shp, -1, dtype=dt, device=device)
        return torch.zeros(shp, dtype=dt, device=device)
    return make(cache_spec(cfg, shape, kv_int8))


def _quantize_kv(x: torch.Tensor):
    """x: (...,KV,D) -> (int8 (...,KV,D), scale (...,KV,1) bf16): the
    scale is max |x| over D / 127, at least 1e-8; the values are x over
    the float32 scale, rounded half to even and clipped to +-127."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.float() * scale.float()).to(torch.bfloat16)


def quantize_cache(cfg: ArchConfig, cache) -> Dict[str, Any]:
    """A stacked family's bf16 cache (a prefill's) as an int8 cache:
    every slot's k and v through `_quantize_kv`, the scales beside them;
    positions and Whisper's cross-attention cache kept. (A prefill
    returns bf16, as the reference's does; the reference has no
    conversion.)"""
    _check_int8(cfg, True)
    out = dict(cache)
    for name in ("k", "v"):
        out[name], out[f"{name}_scale"] = _quantize_kv(cache[name])
    return out


# --------------------------------------------------------------------------
# decode steps
# --------------------------------------------------------------------------

def clear_row(cfg: ArchConfig, cache, row: int):
    """Empty batch row ``row`` of a cache in place: every slot of every
    layer at position -1, and the recurrent state (the hybrid family's
    SSM state, RWKV's state and token-shift inputs) at zero
    (`init_cache`'s values), an int8 cache's scales at zero. Whisper's
    cross-attention rows are left as they are: no step writes them.
    Returns the cache."""
    if cfg.attn_free:
        for name in ("state", "x_tm", "x_cm"):
            cache[name][:, row] = 0
        return cache
    layers = cache["layers"] if cfg.family == "hybrid" else [cache]
    for lc in layers:
        lc["pos"][row] = -1
    for name in ("k_scale", "v_scale"):
        if name in cache:
            cache[name][:, row] = 0
    if cfg.family == "hybrid":
        cache["ssm"][:, row] = 0
    return cache


def _write(dst: torch.Tensor, src: torch.Tensor, row: Optional[int]):
    """``dst`` = ``src`` in place: batch row ``row``, or every row."""
    if row is None:
        dst.copy_(src)
    else:
        dst[row].copy_(src[row])


def _attn_decode(cfg, p, nx, ck, cv, cpos, step: int, is_global=None,
                 row=None, scales=None):
    """nx: (B,1,d). Returns the attention output; the cache (its row
    ``row``, every row if None) is updated in place. M-RoPE puts ``step``
    on all three position columns, as the reference does. With
    ``scales`` = (k_scale, v_scale) the cache is int8: the new token's k
    and v are quantized as they are written, and attention reads the
    layer's cache dequantized to bf16 (transient, one layer at a time)."""
    q, k, v = _project_qkv(cfg, p, nx)
    B = nx.shape[0]
    if cfg.rope_theta:
        pos = torch.full((B, 1), step, dtype=torch.int32, device=nx.device)
        if cfg.mrope_sections:
            pos = pos[..., None].expand(B, 1, 3)
        ang = rope_angles(pos, cfg.resolved_head_dim, cfg.rope_theta,
                          cfg.mrope_sections)
        q, k = apply_rope(q, ang), apply_rope(k, ang)
    window = cfg.swa_window if cfg.swa_window else 0
    if scales is not None:
        ks, vs = scales
        (kq, ksc), (vq, vsc) = _quantize_kv(k), _quantize_kv(v)
        attn_lib.cache_update(ks, vs, cpos, ksc, vsc, step, row=row)
        attn_lib.cache_update(ck, cv, cpos, kq, vq, step, row=row)
        o = attn_lib.decode_attention(q, _dequantize_kv(ck, ks),
                                      _dequantize_kv(cv, vs), cpos,
                                      window=window, is_global=is_global)
    else:
        attn_lib.cache_update(ck, cv, cpos, k.to(ck.dtype), v.to(cv.dtype),
                              step, row=row)
        o = attn_lib.decode_attention(q, ck, cv, cpos, window=window,
                                      is_global=is_global)
    return fdot(o.reshape(B, 1, -1), p["wo"])


def decode_step(cfg: ArchConfig, params, cache, tokens: torch.Tensor,
                step: int, row: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: (B,1) int; step: the absolute position (a Python int).
    Returns (logits (B,1,V), cache) with the cache updated in place: its
    batch row ``row``, or every row if None (the reference's step). The
    whole batch runs either way; a mixture-of-experts layer routes every
    row, and each takes expert capacity."""
    params = cast_params(cfg, params)
    step = int(step)
    if cfg.attn_free:
        return _decode_rwkv(cfg, params, cache, tokens, step, row)
    if cfg.family == "hybrid":
        return _decode_hybrid(cfg, params, cache, tokens, step, row)
    return _decode_stacked(cfg, params, cache, tokens, step, row)


def _embed_decode(cfg, params, tokens, step):
    x = params["embed"]["tokens"].to(getattr(torch, cfg.dtype))[
        tokens.long()]
    if not cfg.rope_theta and not cfg.mrope_sections:
        pos = torch.full(tokens.shape, step, dtype=torch.int32,
                         device=tokens.device)
        x = x + sinusoidal_at(pos, cfg.d_model, x.dtype)
    return x


def _logits(cfg, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ head_weight(cfg, params).to(x.dtype)


def _decode_stacked(cfg, params, cache, tokens, step, row):
    """dense / vlm / moe / Whisper's decoder: a loop over the stacked
    layers. Every layer writes the same slot of the shared position row;
    an int8 cache (int8 "k") also its scales.
    Whisper's decoder attends to the cross-attention cache at positions
    0..Se-1 after self-attention."""
    x = _embed_decode(cfg, params, tokens, step)
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    int8 = cache["k"].dtype == torch.int8
    if cfg.enc_dec:
        Se = cache["xk"].shape[2]
        xpos = torch.arange(Se, dtype=torch.int32,
                            device=x.device).expand(B, Se)
    for i in range(cfg.n_layers):
        lp = layer_params(params["blocks"], i)
        nx = rms_norm(x, lp["norm1"], cfg.norm_eps)
        a = _attn_decode(cfg, lp["attn"], nx, cache["k"][i], cache["v"][i],
                         cache["pos"], step, row=row,
                         scales=((cache["k_scale"][i], cache["v_scale"][i])
                                 if int8 else None))
        x = x + a
        if cfg.enc_dec:
            nx = rms_norm(x, lp["norm3"], cfg.norm_eps)
            q = (nx @ lp["xattn"]["wq"]).reshape(B, 1, cfg.n_heads, hd)
            o = attn_lib.decode_attention(q, cache["xk"][i], cache["xv"][i],
                                          xpos)
            x = x + o.reshape(B, 1, -1) @ lp["xattn"]["wo"]
        nx = rms_norm(x, lp["norm2"], cfg.norm_eps)
        if cfg.is_moe:
            m, _aux = moe_lib.moe_ffn(cfg, lp["moe"], nx)
            x = x + m
        else:
            x = x + _mlp(cfg, lp["mlp"], nx)
    return _logits(cfg, params, x), cache


def _decode_rwkv(cfg, params, cache, tokens, step, row):
    """rwkv6: one step of every layer's recurrence from the cached state
    and token-shift inputs."""
    x = _embed_decode(cfg, params, tokens, step)
    for i in range(cfg.n_layers):
        x_tm, x_cm = cache["x_tm"][i], cache["x_cm"][i]
        x, st, x_tm_new, x_cm_new = rwkv_block_fwd(
            cfg, layer_params(params["blocks"], i), x, cache["state"][i],
            x_tm.to(x.dtype), x_cm.to(x.dtype))
        _write(cache["state"][i], st, row)
        _write(x_tm, x_tm_new.to(x_tm.dtype), row)
        _write(x_cm, x_cm_new.to(x_cm.dtype), row)
    return _logits(cfg, params, x), cache


def _decode_hybrid(cfg, params, cache, tokens, step, row):
    """hymba: per-layer caches of two widths, and the SSM state."""
    x = _embed_decode(cfg, params, tokens, step)
    for i in range(cfg.n_layers):
        lp = layer_params(params["blocks"], i)
        lc = cache["layers"][i]
        nx = rms_norm(x, lp["norm1"], cfg.norm_eps)
        a = _attn_decode(cfg, lp["attn"], nx, lc["k"], lc["v"], lc["pos"],
                         step, is_global=bool(is_global_layer(cfg, i)),
                         row=row)
        s, st = ssm_lib.ssm_decode_step(cfg, lp["ssm"], nx, cache["ssm"][i])
        _write(cache["ssm"][i], st, row)
        fs = lp["fuse_scale"]
        x = x + 0.5 * (fs[0] * a + fs[1] * s)
        nx = rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + _mlp(cfg, lp["mlp"], nx)
    return _logits(cfg, params, x), cache


# --------------------------------------------------------------------------
# prefill: forward pass that also returns a populated cache
# --------------------------------------------------------------------------

def _pad_cache_entry(k, v, pos, width: int):
    """Extend a (B,S,KV,D) cache to `width` slots (empty slots pos=-1), or
    keep its last `width` positions, rolled so that position p sits in
    ring slot p % width, where `attention.cache_update` writes and evicts.
    (The reference keeps them unrolled: when S % width != 0 its first
    decode steps overwrite positions still inside the window.)"""
    S = k.shape[1]
    if width <= S:
        return tuple(t[:, S - width:].roll(S % width, dims=1)
                     for t in (k, v, pos))
    B = k.shape[0]
    pad = k.new_zeros((B, width - S) + tuple(k.shape[2:]))
    k = torch.cat([k, pad], dim=1)
    v = torch.cat([v, pad], dim=1)
    pos = torch.cat([pos, pos.new_full((B, width - S), -1)], dim=1)
    return k, v, pos


def prefill(cfg: ArchConfig, params, batch, max_len: int = 0
            ) -> Tuple[torch.Tensor, Dict]:
    """Runs the full forward and materializes the decode cache.

    `max_len` sets the decode horizon: full-attention caches are padded to
    that many slots (ring-buffer alignment: prompt token i sits in slot i).
    Returns (last-position logits (B,V), cache). The head is applied to
    the last position only: the reference computes every position's
    logits and keeps the last."""
    with span("prefill_step"):
        params = cast_params(cfg, params)
        x, entries, _aux, enc_out = run_blocks(cfg, params, batch,
                                               collect=True)
        with span("lm_head"):
            logits = fdot(x[:, -1], head_weight(cfg, params).to(x.dtype))
        with span("cache_pack"):
            B, S = batch["tokens"].shape
            cache = _pack_cache(cfg, params, entries, enc_out, B, S,
                                max(max_len, S), x.device)
        return logits, cache


def _pack_cache(cfg: ArchConfig, params, entries, enc_out, B: int, S: int,
                max_len: int, dev) -> Dict:
    """A prefill's cache from its per-layer entries (`prefill`): bf16
    keys and values padded to their slots, the positions, the recurrent
    states."""
    bf16 = torch.bfloat16
    if cfg.attn_free:
        st, x_tm, x_cm = (torch.stack(t) for t in zip(*entries))
        return {"state": st, "x_tm": x_tm.to(bf16), "x_cm": x_cm.to(bf16)}
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    if cfg.family == "hybrid":
        layers, states = [], []
        for i, ((k, v), state) in enumerate(entries):
            wi = (max_len if is_global_layer(cfg, i)
                  else min(cfg.swa_window, max_len))
            k, v, p = _pad_cache_entry(k.to(bf16), v.to(bf16), pos, wi)
            layers.append({"k": k.contiguous(), "v": v.contiguous(),
                           "pos": p.contiguous()})
            states.append(state)
        return {"layers": layers, "ssm": torch.stack(states)}
    W = _cache_width(cfg, max_len)
    ks, vs = [], []
    for k, v in entries:
        k, v, p = _pad_cache_entry(k.to(bf16), v.to(bf16), pos, W)
        ks.append(k)
        vs.append(v)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "pos": p.contiguous()}
    if cfg.enc_dec:
        # every layer's cross keys and values from the encoder's output,
        # with plain products, a second time after block_fwd's (the
        # reference computes them so)
        Se, KV, hd = enc_out.shape[1], cfg.n_kv_heads, cfg.resolved_head_dim
        xk, xv = [], []
        for i in range(cfg.n_layers):
            xp = layer_params(params["blocks"]["xattn"], i)
            xk.append((enc_out @ xp["wk"]).reshape(B, Se, KV, hd).to(bf16))
            xv.append((enc_out @ xp["wv"]).reshape(B, Se, KV, hd).to(bf16))
        cache["xk"], cache["xv"] = torch.stack(xk), torch.stack(xv)
    return cache
