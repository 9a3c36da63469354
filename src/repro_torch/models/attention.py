"""Grouped-query attention: full, kv-chunked (online softmax), the flash
kernel, and single-token decode against a (possibly ring-buffered) cache.

The port of `repro.models.attention`. Shapes at the public functions are
the reference's: q (B,Sq,H,D); k, v (B,Sk,KV,D) with H = KV*G. KV heads
are never expanded to H.

Dispatch in `attention`: a call of Sq <= Sk queries whose mask the
kernel computes goes to `kernels.ops.flash_attention` — the CUDA kernel
on a card, its plain version on the CPU. The kernel aligns the causal
mask bottom-right (query i at key position Sk - Sq + i), so a causal call
goes there when ``q_offset == Sk - Sq`` (the whole sequence, or a block
of its queries over the keys up to the block's end, as a context-
parallel shard holds them); a full mask (Whisper's cross-attention, 224
queries over 1500 frames) at any offset. And no window may be in effect:
``window == 0``, a global layer (``is_global`` True), or ``window >
q_offset + Sq - 1``, the largest ``qp - kp``, so that ``(qp - kp) <
window`` holds for every pair. A window that does cut keys stays plain
PyTorch (`full_attention` / `blocked_attention`, and `chunked_attention`
for a call at an offset, which `blocked_attention` does not take), as the
reference computes it outside any kernel; the kernel, like the TPU kernel
it replaces, takes no window.

``is_global`` is a static Python bool here (None: the layer has no
global/window split). The reference traces it under ``lax.scan``; the
port's layer loop is Python, so each layer knows its own.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def _mask(q_pos, k_pos, *, causal: bool, window: int,
          is_global: Optional[bool]) -> torch.Tensor:
    """(…,Sq,Sk) boolean mask; a global layer ignores the window."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    allowed = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                         dtype=torch.bool, device=qp.device)
    if causal:
        allowed &= kp <= qp
    if window and not is_global:
        allowed &= (qp - kp) < window
    return allowed


def _promoted(a: torch.Tensor, b: torch.Tensor):
    """Both operands in their promoted type, as jnp.einsum promotes (a
    float32 model reads the bf16 KV cache)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def full_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                   is_global=None, k_positions=None):
    """Plain attention; scores materialized. Use for seq <= ~8k."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    q5 = q.reshape(B, Sq, KV, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q5.float(), k.float())
    scores = scores * D ** -0.5
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = (torch.arange(k.shape[1], device=q.device)
             if k_positions is None else k_positions)
    allowed = _mask(q_pos, k_pos, causal=causal, window=window,
                    is_global=is_global)
    scores = scores.masked_fill(~allowed, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, D)


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      k_offset=0, chunk=2048, is_global=None):
    """Flash-style attention: a loop over KV chunks with online softmax.
    Peak memory is O(Sq*chunk) instead of O(Sq*Sk)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if Sk % chunk != 0:
        return full_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, is_global=is_global,
                              k_positions=k_offset + torch.arange(
                                  Sk, device=q.device))
    q5 = (q.reshape(B, Sq, KV, G, D) * D ** -0.5).to(q.dtype)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, D), dtype=torch.float32,
                      device=q.device)
    for ci in range(Sk // chunk):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        k_pos = k_offset + ci * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqkgd,bskd->bkgqs", q5.float(), kb.float())
        allowed = _mask(q_pos, k_pos, causal=causal, window=window,
                        is_global=is_global)
        s = s.masked_fill(~allowed, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        scale = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * scale + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(q.dtype), vb)
        acc = acc * scale[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def blocked_attention(q, k, v, *, causal=True, window=0, chunk=2048,
                      is_global=None):
    """Flash-style blocking on both axes: a loop over Q blocks, online
    softmax over KV chunks inside. Causal and windowed Q blocks skip the KV
    chunks outside their receptive field; a global layer keeps them all."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qc = min(Sq, 2 * chunk)
    if Sq % qc != 0:
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 chunk=chunk, is_global=is_global)
    outs = []
    static_window = window if (window and not is_global) else 0
    for qi in range(Sq // qc):
        q_off = qi * qc
        qb = q[:, q_off:q_off + qc]
        lo, hi = 0, Sk
        if causal:
            hi = min(Sk, q_off + qc)
        if static_window:
            lo = max(0, q_off - static_window + 1)
        lo = (lo // chunk) * chunk           # align to the chunk grid
        hi = -(-hi // chunk) * chunk if hi % chunk else hi
        hi = min(hi, Sk)
        outs.append(chunked_attention(
            qb, k[:, lo:hi], v[:, lo:hi], causal=causal, window=window,
            chunk=chunk, is_global=is_global, q_offset=q_off, k_offset=lo))
    return torch.cat(outs, dim=1)


def uses_kernel(Sq: int, Sk: int, *, window: int, q_offset: int,
                is_global: Optional[bool], causal: bool = True) -> bool:
    """Whether `attention` sends this call to the flash kernel: Sq <= Sk,
    a causal mask aligned bottom-right or a full one, with no window in
    effect (module docstring)."""
    if Sq > Sk or (causal and q_offset != Sk - Sq):
        return False
    return not window or bool(is_global) or window >= q_offset + Sq


def attention(q, k, v, *, causal=True, window=0, q_offset=0, chunk=2048,
              is_global=None):
    if uses_kernel(q.shape[1], k.shape[1], window=window, q_offset=q_offset,
                   is_global=is_global, causal=causal):
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal)
        return o.transpose(1, 2)
    if q_offset and k.shape[1] > chunk:
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, chunk=chunk,
                                 is_global=is_global)
    if k.shape[1] > chunk:
        return blocked_attention(q, k, v, causal=causal, window=window,
                                 chunk=chunk, is_global=is_global)
    return full_attention(q, k, v, causal=causal, window=window,
                          q_offset=q_offset, is_global=is_global)


def decode_attention(q, cache_k, cache_v, cache_pos, *, window=0,
                     is_global=None):
    """One-token decode. cache_k/v: (B,W,KV,D); cache_pos: (B,W) int32 of
    the absolute position stored in each slot (-1 = empty).
    Ring-buffer-safe."""
    B, _one, H, D = q.shape
    KV = cache_k.shape[2]
    G = H // KV
    q4 = q.reshape(B, KV, G, D) * D ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", q4.float(), cache_k.float())
    valid = cache_pos >= 0
    if window and not is_global:
        cur = cache_pos.amax(dim=-1, keepdim=True)
        valid &= (cur - cache_pos) < window
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", *_promoted(p, cache_v))
    return out.reshape(B, 1, H, D)


def cache_update(cache_k, cache_v, cache_pos, k_new, v_new, step: int,
                 row=None):
    """Write one token into a ring buffer at slot ``step % W``: in batch
    row ``row``, or in every row if None.

    Unlike the reference's pure update this writes IN PLACE (a decode step
    would otherwise copy the whole cache) and returns the same tensors."""
    step = int(step)
    slot = step % cache_k.shape[1]
    rows = slice(None) if row is None else slice(row, row + 1)
    cache_k[rows, slot] = k_new[rows, 0]
    cache_v[rows, slot] = v_new[rows, 0]
    cache_pos[rows, slot] = step
    return cache_k, cache_v, cache_pos
