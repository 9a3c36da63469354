"""Decoder stack of the dense and hybrid LM families, in PyTorch.

The port of `repro.models.transformer` for the serving slice. Parameters
are the reference's nested dicts with layers stacked on a leading L axis;
the reference's ``lax.scan`` over layers is a Python loop here, so each
layer's ``is_global`` is a static bool. One block function serves the
dense family (Granite, Qwen), the hybrid one (Hymba: attention and SSM
heads in parallel in every layer) and the mixture-of-experts one
(Mixtral, Moonlight: `models.moe` in place of the MLP).

Not ported yet, and refused with NotImplementedError: RWKV-6
(``attn_free``), Whisper's encoder-decoder (``enc_dec``) and the VLM
frontend (``n_vision_tokens``, M-RoPE). ``loss_fn`` and remat wait for
the training slice.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (ParamTable, activation, apply_rope,
                                       fdot, rms_norm, rope_angles,
                                       tree_map)


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for the families the port lacks."""
    missing = [what for what, flag in (
        ("rwkv6 (attn_free)", cfg.attn_free),
        ("encoder-decoder (enc_dec)", cfg.enc_dec),
        ("vlm (n_vision_tokens / mrope_sections)",
         cfg.n_vision_tokens or cfg.mrope_sections)) if flag]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port does not cover {', '.join(missing)} yet "
            f"(dense, hybrid and mixture-of-experts families only)")


def is_global_layer(cfg: ArchConfig, i: int) -> Optional[bool]:
    """Layer i's global flag; None when the stack has no SWA/global split
    (the reference passes no flag then)."""
    if cfg.swa_window and cfg.global_attn_every:
        return i % cfg.global_attn_every == 0
    return None


# --------------------------------------------------------------------------
# parameter declaration
# --------------------------------------------------------------------------

def _declare_attn(t: ParamTable, prefix: str, cfg: ArchConfig, L: int):
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    t.add(f"{prefix}/wq", (L, d, H * hd))
    t.add(f"{prefix}/wk", (L, d, KV * hd))
    t.add(f"{prefix}/wv", (L, d, KV * hd))
    t.add(f"{prefix}/wo", (L, H * hd, d))
    if cfg.qkv_bias:
        t.add(f"{prefix}/bq", (L, H * hd), init="zeros")
        t.add(f"{prefix}/bk", (L, KV * hd), init="zeros")
        t.add(f"{prefix}/bv", (L, KV * hd), init="zeros")


def _declare_mlp(t: ParamTable, prefix: str, cfg: ArchConfig, L: int):
    d, f = cfg.d_model, cfg.d_ff
    t.add(f"{prefix}/w_gate", (L, d, f))
    t.add(f"{prefix}/w_up", (L, d, f))
    t.add(f"{prefix}/w_down", (L, f, d))


def build_param_table(cfg: ArchConfig) -> ParamTable:
    check_supported(cfg)
    t = ParamTable()
    d, L = cfg.d_model, cfg.n_layers
    t.add("embed/tokens", (cfg.vocab_size, d), init="embed", scale=0.02)
    if not cfg.tie_embeddings:
        t.add("head/w", (d, cfg.vocab_size))
    t.add("final_norm", (d,), init="ones")
    t.add("blocks/norm1", (L, d), init="ones")
    t.add("blocks/norm2", (L, d), init="ones")
    _declare_attn(t, "blocks/attn", cfg, L)
    if cfg.family == "hybrid":
        ssm_lib.declare_ssm(t, "blocks/ssm", cfg, L)
        t.add("blocks/fuse_scale", (L, 2, d), init="ones")
    if cfg.is_moe:
        moe_lib.declare_moe(t, "blocks/moe", cfg, L)
    else:
        _declare_mlp(t, "blocks/mlp", cfg, L)
    return t


def cast_params(cfg: ArchConfig, params):
    """Every float32 leaf to the compute type (a no-op for parameters
    already stored in it)."""
    dt = getattr(torch, cfg.dtype)
    return tree_map(
        lambda p: p.to(dt) if p.dtype == torch.float32 else p, params)


def layer_params(blocks: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer i of the stacked block parameters (views, no copy)."""
    return tree_map(lambda a: a[i], blocks)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _project_qkv(cfg, p, x):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = fdot(x, p["wq"])
    k = fdot(x, p["wk"])
    v = fdot(x, p["wv"])
    if cfg.qkv_bias and "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, cfg.n_heads, hd),
            k.reshape(B, S, cfg.n_kv_heads, hd),
            v.reshape(B, S, cfg.n_kv_heads, hd))


def _mlp(cfg, p, x):
    act = activation(cfg.act)
    return fdot(act(fdot(x, p["w_gate"])) * fdot(x, p["w_up"]), p["w_down"])


def _attn_block(cfg, p, x, positions, *, causal=True, is_global=None):
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.rope_theta:
        ang = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
        q, k = apply_rope(q, ang), apply_rope(k, ang)
    o = attn_lib.attention(q, k, v, causal=causal, window=cfg.swa_window,
                           chunk=cfg.attn_chunk, is_global=is_global)
    return fdot(o.reshape(*x.shape[:2], -1), p["wo"]), (k, v)


def block_fwd(cfg: ArchConfig, p: Dict[str, Any], x: torch.Tensor,
              positions: torch.Tensor, is_global: Optional[bool] = None):
    """One decoder block. Returns (x, cache entry, moe_aux): the entry is
    (k, v), and for the hybrid family ((k, v), final SSM state); moe_aux
    is the layer's load-balancing loss (zero without experts)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    nx = rms_norm(x, p["norm1"], cfg.norm_eps)
    a_out, kv = _attn_block(cfg, p["attn"], nx, positions,
                            is_global=is_global)
    if cfg.family == "hybrid":
        s_out, s_state = ssm_lib.ssm_scan(cfg, p["ssm"], nx)
        kv = (kv, s_state)                                # cache needs both
        fs = p["fuse_scale"]
        x = x + 0.5 * (fs[0] * a_out + fs[1] * s_out)
    else:
        x = x + a_out
    nx = rms_norm(x, p["norm2"], cfg.norm_eps)
    if cfg.is_moe:
        m_out, aux = moe_lib.moe_ffn(cfg, p["moe"], nx)
        x = x + m_out
    else:
        x = x + _mlp(cfg, p["mlp"], nx)
    return x, kv, aux


# --------------------------------------------------------------------------
# full forward (prefill)
# --------------------------------------------------------------------------

def embed_inputs(cfg: ArchConfig, params, batch
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    tokens = batch["tokens"]
    x = params["embed"]["tokens"].to(getattr(torch, cfg.dtype))[
        tokens.long()]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    return x, positions


def head_weight(cfg: ArchConfig, params) -> torch.Tensor:
    return (params["embed"]["tokens"].T if cfg.tie_embeddings
            else params["head"]["w"])


def run_blocks(cfg: ArchConfig, params, batch, collect: bool = False
               ) -> Tuple[torch.Tensor, List[Any], torch.Tensor]:
    """Embed, every block and the final norm over cast parameters.
    Returns (hidden (B,S,d), per-layer cache entries if ``collect``, the
    summed moe_aux)."""
    check_supported(cfg)
    x, positions = embed_inputs(cfg, params, batch)
    entries = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, entry, layer_aux = block_fwd(
            cfg, layer_params(params["blocks"], i), x, positions,
            is_global=is_global_layer(cfg, i))
        aux = aux + layer_aux
        if collect:
            entries.append(entry)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), entries, aux


def forward(cfg: ArchConfig, params, batch, kind: str = "train"):
    """Returns (logits (B,S,V), moe_aux, (cache entries or None, None)),
    the reference's triple: moe_aux is the layers' summed load-balancing
    loss (zero without experts), and ``kind="prefill"`` also returns the
    per-layer cache entries (a list, where the reference stacks them on
    the L axis)."""
    params = cast_params(cfg, params)
    x, entries, aux = run_blocks(cfg, params, batch,
                                 collect=kind == "prefill")
    logits = fdot(x, head_weight(cfg, params).to(x.dtype))
    return logits, aux, (entries if kind == "prefill" else None, None)
