"""Architecture + shape configuration dataclasses (a copy of the
reference's `repro.configs.base`, which the port does not import).

Every assigned architecture gets one module in ``repro_torch/configs/``
that exports ``CONFIG`` (the exact published configuration) and
``REDUCED`` (a tiny same-family configuration for CPU smoke tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # ---- attention ----
    swa_window: int = 0              # 0 -> full attention
    global_attn_every: int = 0       # hybrid: every k-th layer uses global attn
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl multimodal rope
    attn_chunk: int = 2048           # kv-chunk for memory-efficient attention
    # ---- mixture of experts ----
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    # ---- state space / rwkv ----
    ssm_state: int = 0
    attn_free: bool = False          # rwkv6: no attention at all
    # ---- encoder-decoder (whisper) ----
    enc_dec: bool = False
    enc_layers: int = 0
    enc_len: int = 1500              # whisper: fixed 30s -> 1500 frames
    # ---- vlm stub frontend ----
    n_vision_tokens: int = 0
    # ---- misc ----
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def subquadratic(self) -> bool:
        """True if the arch can decode 500k-token contexts (no full-attn KV)."""
        return self.attn_free or self.family in ("ssm", "hybrid") or (
            self.swa_window > 0 and self.global_attn_every == 0)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        hd = self.resolved_head_dim
        qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
        o = (self.n_heads * hd) * d
        attn = qkv + o
        if self.is_moe:
            mlp = self.n_experts * 3 * d * self.expert_d_ff + d * self.n_experts
        else:
            mlp = 3 * d * f
        if self.attn_free:  # rwkv6: r,k,v,w,g,o projections + ffn(2 mats)
            attn = 6 * d * d
            mlp = 2 * d * f
        if self.family in ("hybrid",):
            attn += 3 * d * d  # ssm branch projections (approx)
        blocks = L * (attn + mlp + 2 * d)
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.enc_dec:
            blocks += self.enc_layers * (attn + mlp + 2 * d)
            blocks += L * (2 * d * d + 2 * d * (self.n_kv_heads * hd))  # cross-attn
        return emb + blocks

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        dense = self.param_count() - L * self.n_experts * 3 * d * self.expert_d_ff
        return dense + L * self.top_k * 3 * d * self.expert_d_ff


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode
    grad_accum: int = 1              # microbatch count for training shapes


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train", grad_accum=8)
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def supports(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; reason if skipped."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, ("full-attention arch: 500k-token decode needs a "
                       "sub-quadratic mixer (see DESIGN.md skip table)")
    return True, ""


def reduced(cfg: ArchConfig, **over) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        swa_window=min(cfg.swa_window, 16) if cfg.swa_window else 0,
        attn_chunk=8,
        n_experts=4 if cfg.is_moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.is_moe else 0,
        expert_d_ff=64 if cfg.is_moe else 0,
        # drop-free capacity so decode/forward parity is exact in tests
        capacity_factor=8.0 if cfg.is_moe else cfg.capacity_factor,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        enc_layers=2 if cfg.enc_dec else 0,
        enc_len=16 if cfg.enc_dec else cfg.enc_len,
        n_vision_tokens=4 if cfg.n_vision_tokens else 0,
        remat=False,
    )
    kw.update(over)
    return dataclasses.replace(cfg, **kw)
