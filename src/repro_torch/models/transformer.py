"""Decoder stack of every LM family, in PyTorch.

The port of `repro.models.transformer` for the serving slice. Parameters
are the reference's nested dicts with layers stacked on a leading L axis;
the reference's ``lax.scan`` over layers is a Python loop here, so each
layer's ``is_global`` is a static bool. One block function serves the
dense family (Granite, Qwen), the VLM (Qwen2-VL: M-RoPE over (t, h, w)
positions, vision embeddings in place of the first tokens), the hybrid
one (Hymba: attention and SSM heads in parallel in every layer), the
mixture-of-experts one (Mixtral, Moonlight: `models.moe` in place of the
MLP) and Whisper's decoder (cross-attention to the encoder's output);
RWKV-6 (``attn_free``) has its own block (`models.rwkv`), and Whisper an
encoder stack (`encode`).

Training: ``loss_fn`` is the reference's next-token NLL over sequence
chunks of `LOSS_CHUNK` (the (B,S,V) logits are never whole in memory),
and under ``cfg.remat`` a forward of kind "train" or "hidden" that
records gradients runs each block (decoder, RWKV and Whisper's encoder)
under `torch.utils.checkpoint`: only the blocks' inputs stay alive, and
the backward recomputes one block at a time (the reference's
``jax.checkpoint`` with ``nothing_saveable``). Float32 master parameters
go through `cast_params`, so their gradients land in float32. The
stacked parameters are split into per-layer views with ``unbind``, whose
backward stacks the layers' gradients once (a per-layer index would add
a zero-filled (L, ...) gradient for every layer).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (ParamTable, activation, apply_rope,
                                       fdot, head_axis, kv_axis, rms_norm,
                                       rope_angles,
                                       sinusoidal_at, sinusoidal_positions,
                                       tree_map, wide)
from repro_torch.spans import span

MOE_AUX_WEIGHT = 0.01
LOSS_CHUNK = 512


def is_global_layer(cfg: ArchConfig, i: int) -> Optional[bool]:
    """Layer i's global flag; None when the stack has no SWA/global split
    (the reference passes no flag then)."""
    if cfg.swa_window and cfg.global_attn_every:
        return i % cfg.global_attn_every == 0
    return None


# --------------------------------------------------------------------------
# parameter declaration
# --------------------------------------------------------------------------

def _declare_attn(t: ParamTable, prefix: str, cfg: ArchConfig, L: int,
                  cross: bool = False):
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    # head counts that do not divide the production model axis get the
    # "_flat" logical axes, which the tensor-parallel rules replicate
    ha, ka = head_axis(H), kv_axis(KV)
    t.add(f"{prefix}/wq", (L, d, H * hd), ("layers", "embed", ha))
    t.add(f"{prefix}/wk", (L, d, KV * hd), ("layers", "embed", ka))
    t.add(f"{prefix}/wv", (L, d, KV * hd), ("layers", "embed", ka))
    t.add(f"{prefix}/wo", (L, H * hd, d), ("layers", ha, "embed"))
    if cfg.qkv_bias and not cross:
        t.add(f"{prefix}/bq", (L, H * hd), ("layers", ha), init="zeros")
        t.add(f"{prefix}/bk", (L, KV * hd), ("layers", ka), init="zeros")
        t.add(f"{prefix}/bv", (L, KV * hd), ("layers", ka), init="zeros")


def _declare_mlp(t: ParamTable, prefix: str, cfg: ArchConfig, L: int):
    d, f = cfg.d_model, cfg.d_ff
    t.add(f"{prefix}/w_gate", (L, d, f), ("layers", "embed", "ff"))
    t.add(f"{prefix}/w_up", (L, d, f), ("layers", "embed", "ff"))
    t.add(f"{prefix}/w_down", (L, f, d), ("layers", "ff", "embed"))


def build_param_table(cfg: ArchConfig) -> ParamTable:
    t = ParamTable()
    d, L = cfg.d_model, cfg.n_layers
    t.add("embed/tokens", (cfg.vocab_size, d), ("vocab", "embed"),
          init="embed", scale=0.02)
    if not cfg.tie_embeddings:
        t.add("head/w", (d, cfg.vocab_size), ("embed", "vocab"))
    t.add("final_norm", (d,), (None,), init="ones")
    t.add("blocks/norm1", (L, d), ("layers", None), init="ones")
    t.add("blocks/norm2", (L, d), ("layers", None), init="ones")
    if cfg.attn_free:                                     # rwkv6
        rwkv_lib.declare_rwkv(t, "blocks/rwkv", cfg, L)
        return t
    _declare_attn(t, "blocks/attn", cfg, L)
    if cfg.family == "hybrid":
        ssm_lib.declare_ssm(t, "blocks/ssm", cfg, L)
        t.add("blocks/fuse_scale", (L, 2, d), ("layers", None, None),
              init="ones")
    if cfg.is_moe:
        moe_lib.declare_moe(t, "blocks/moe", cfg, L)
    else:
        _declare_mlp(t, "blocks/mlp", cfg, L)
    if cfg.enc_dec:                                       # whisper
        Le = cfg.enc_layers
        t.add("enc_blocks/norm1", (Le, d), ("layers", None), init="ones")
        t.add("enc_blocks/norm2", (Le, d), ("layers", None), init="ones")
        _declare_attn(t, "enc_blocks/attn", cfg, Le)
        _declare_mlp(t, "enc_blocks/mlp", cfg, Le)
        t.add("enc_final_norm", (d,), (None,), init="ones")
        t.add("blocks/norm3", (L, d), ("layers", None), init="ones")
        _declare_attn(t, "blocks/xattn", cfg, L, cross=True)
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


def unstack(blocks: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every layer's parameters of a stacked block tree, as views made by
    one ``unbind`` per leaf (module docstring)."""
    if isinstance(blocks, dict):
        cols = {k: unstack(v) for k, v in blocks.items()}
        n = len(next(iter(cols.values())))
        return [{k: c[i] for k, c in cols.items()} for i in range(n)]
    return list(blocks.unbind(0))


def _remat(fn, on: bool, *args, **kw):
    """``fn(*args, **kw)``, under a non-reentrant checkpoint when ``on``
    and autograd is recording (the model draws no random numbers, so no
    RNG state is kept)."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return fn(*args, **kw)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _project_qkv(cfg, p, x):
    with span("qkv_proj"):
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
    with span("mlp"):
        act = activation(cfg.act)
        return fdot(act(fdot(x, p["w_gate"])) * fdot(x, p["w_up"]),
                    p["w_down"])


def _attn_block(cfg, p, x, positions, *, causal=True, is_global=None):
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.rope_theta:
        with span("rope"):
            ang = rope_angles(positions, cfg.resolved_head_dim,
                              cfg.rope_theta, cfg.mrope_sections)
            q, k = apply_rope(q, ang), apply_rope(k, ang)
    o = attn_lib.attention(q, k, v, causal=causal, window=cfg.swa_window,
                           chunk=cfg.attn_chunk, is_global=is_global)
    with span("attn_out"):
        return fdot(o.reshape(*x.shape[:2], -1), p["wo"]), (k, v)


def block_fwd(cfg: ArchConfig, p: Dict[str, Any], x: torch.Tensor,
              positions: torch.Tensor, is_global: Optional[bool] = None,
              enc_out: Optional[torch.Tensor] = None):
    """One decoder block. Returns (x, cache entry, moe_aux): the entry is
    (k, v), and for the hybrid family ((k, v), final SSM state); moe_aux
    is the layer's load-balancing loss (zero without experts). With
    ``enc_out`` (Whisper) the block attends to it after self-attention,
    under a full mask: fewer queries than the encoder's keys, which the
    kernel takes (`attention.uses_kernel`)."""
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
    if enc_out is not None:                               # whisper cross-attn
        nx = rms_norm(x, p["norm3"], cfg.norm_eps)
        B, Se, _ = enc_out.shape
        hd = cfg.resolved_head_dim
        q = fdot(nx, p["xattn"]["wq"]).reshape(
            x.shape[0], x.shape[1], cfg.n_heads, hd)
        kx = fdot(enc_out, p["xattn"]["wk"]).reshape(B, Se, cfg.n_kv_heads,
                                                     hd)
        vx = fdot(enc_out, p["xattn"]["wv"]).reshape(B, Se, cfg.n_kv_heads,
                                                     hd)
        o = attn_lib.attention(q, kx, vx, causal=False, chunk=cfg.attn_chunk)
        x = x + fdot(o.reshape(*x.shape[:2], -1), p["xattn"]["wo"])
    nx = rms_norm(x, p["norm2"], cfg.norm_eps)
    if cfg.is_moe:
        m_out, aux = moe_lib.moe_ffn(cfg, p["moe"], nx)
        x = x + m_out
    else:
        x = x + _mlp(cfg, p["mlp"], nx)
    return x, kv, aux


def rwkv_block_fwd(cfg: ArchConfig, p: Dict[str, Any], x: torch.Tensor,
                   state=None, x_tm=None, x_cm=None):
    """One RWKV-6 block. Returns (x, final state, last time-mix input,
    last channel-mix input)."""
    nx = rms_norm(x, p["norm1"], cfg.norm_eps)
    o, state, x_last_tm = rwkv_lib.time_mix(cfg, p["rwkv"], nx, state, x_tm)
    x = x + o
    nx = rms_norm(x, p["norm2"], cfg.norm_eps)
    o, x_last_cm = rwkv_lib.channel_mix(cfg, p["rwkv"], nx, x_cm)
    return x + o, state, x_last_tm, x_last_cm


# --------------------------------------------------------------------------
# full forward (prefill)
# --------------------------------------------------------------------------

def embed_inputs(cfg: ArchConfig, params, batch
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embeddings (the VLM's ``vision_embeds`` in place of the
    first positions) and positions: ``batch["positions"]`` ((B,S,3) for
    M-RoPE) where given, else 0..S-1. A stack without rotary embeddings
    (Whisper's decoder) adds the sinusoidal encoding here."""
    with span("embed_inputs"):
        tokens = batch["tokens"]
        x = params["embed"]["tokens"].to(getattr(torch, cfg.dtype))[
            tokens.long()]
        if cfg.n_vision_tokens and "vision_embeds" in batch:
            ve = batch["vision_embeds"]
            x[:, :ve.shape[1]] = ve.to(x.dtype)
        if "positions" in batch:
            positions = batch["positions"]
        else:
            B, S = tokens.shape
            positions = torch.arange(S, dtype=torch.int32,
                                     device=tokens.device).expand(B, S)
        if not cfg.rope_theta and not cfg.mrope_sections:
            pos1d = positions if positions.dim() == 2 else positions[..., 0]
            x = x + sinusoidal_at(pos1d, cfg.d_model, x.dtype)
        return x, positions


def head_weight(cfg: ArchConfig, params) -> torch.Tensor:
    return (params["embed"]["tokens"].T if cfg.tie_embeddings
            else params["head"]["w"])


def _enc_block(cfg, lp, x, positions):
    nx = rms_norm(x, lp["norm1"], cfg.norm_eps)
    a, _ = _attn_block(cfg, lp["attn"], nx, positions, causal=False)
    x = x + a
    nx = rms_norm(x, lp["norm2"], cfg.norm_eps)
    return x + _mlp(cfg, lp["mlp"], nx)


def encode(cfg: ArchConfig, params, enc_frames: torch.Tensor
           ) -> torch.Tensor:
    """Whisper's encoder over cast parameters: frames (B,T,d) after the
    conv stub, the interleaved sinusoidal table added, bidirectional
    attention (a full mask) in every layer; each layer under a checkpoint
    with ``cfg.remat`` when autograd records (the reference checkpoints
    the encoder whatever the kind)."""
    x = enc_frames.to(getattr(torch, cfg.dtype))
    B, T, _ = x.shape
    x = x + sinusoidal_positions(T, cfg.d_model, x.dtype, x.device)[None]
    positions = torch.arange(T, dtype=torch.int32,
                             device=x.device).expand(B, T)
    for lp in unstack(params["enc_blocks"]):
        x = _remat(_enc_block, cfg.remat, cfg, lp, x, positions)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def run_blocks(cfg: ArchConfig, params, batch, collect: bool = False,
               remat: bool = False
               ) -> Tuple[torch.Tensor, List[Any], torch.Tensor,
                          Optional[torch.Tensor]]:
    """Embed, the encoder (Whisper), every block and the final norm over
    cast parameters. Returns (hidden (B,S,d), per-layer cache entries if
    ``collect``, the summed moe_aux, the encoder's output or None). An
    RWKV layer's entry is (state, last time-mix input, last channel-mix
    input). With ``remat`` each block runs under a checkpoint while
    autograd records."""
    with span("run_blocks"):
        x, positions = embed_inputs(cfg, params, batch)
        enc_out = (encode(cfg, params, batch["enc_frames"]) if cfg.enc_dec
                   else None)
        entries = []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, lp in enumerate(unstack(params["blocks"])):
            if cfg.attn_free:
                x, *entry = _remat(rwkv_block_fwd, remat, cfg, lp, x)
            else:
                x, entry, layer_aux = _remat(
                    block_fwd, remat, cfg, lp, x, positions,
                    is_global=is_global_layer(cfg, i), enc_out=enc_out)
                aux = aux + layer_aux
            if collect:
                entries.append(entry)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x, entries, aux, enc_out


def forward(cfg: ArchConfig, params, batch, kind: str = "train"):
    """Returns (logits (B,S,V), moe_aux, (cache entries or None, encoder
    output or None)), the reference's triple: moe_aux is the layers'
    summed load-balancing loss (zero without experts), and
    ``kind="prefill"`` also returns the per-layer cache entries (a list,
    where the reference stacks them on the L axis). ``kind="hidden"``
    returns the final-normed hidden states (B,S,d) in place of the
    logits. Kinds "train" and "hidden" checkpoint each block under
    ``cfg.remat``."""
    params = cast_params(cfg, params)
    x, entries, aux, enc_out = run_blocks(
        cfg, params, batch, collect=kind == "prefill",
        remat=cfg.remat and kind in ("train", "hidden"))
    kvs = entries if kind == "prefill" else None
    if kind == "hidden":
        return x, aux, (kvs, enc_out)
    logits = fdot(x, head_weight(cfg, params).to(x.dtype))
    return logits, aux, (kvs, enc_out)


def _chunk_nll(h: torch.Tensor, labels: torch.Tensor, head: torch.Tensor):
    """Summed NLL of one chunk and its count of labels >= 0. The logits
    are the float32 products of the compute-type values (``head`` is
    their float32 copy; float64 in a float64 run, `layers.wide`), as the
    reference's ``preferred_element_type=float32`` gives them."""
    logits = torch.matmul(h.to(head.dtype), head)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return (nll * mask).sum(), mask.sum()


def loss_fn(cfg: ArchConfig, params, batch) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross-entropy over the labels >= 0, plus `MOE_AUX_WEIGHT`
    x the load-balancing loss; returns (total, {"loss", "moe_aux"}), all
    float32 scalars. The head product and log-softmax run per sequence
    chunk of `LOSS_CHUNK` positions (the whole sequence when it does not
    divide) under a checkpoint, so the backward recomputes one chunk's
    logits at a time."""
    hidden, aux, _ = forward(cfg, params, batch, kind="hidden")
    labels = batch["labels"]
    head = wide(head_weight(cfg, params).to(hidden.dtype))
    S = hidden.shape[1]
    c = min(LOSS_CHUNK, S)
    if S % c:
        c = S
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, S, c):
        s, n = _remat(_chunk_nll, True, hidden[:, lo:lo + c],
                      labels[:, lo:lo + c], head)
        tot, cnt = tot + s, cnt + n
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + MOE_AUX_WEIGHT * aux, {"loss": loss, "moe_aux": aux}
