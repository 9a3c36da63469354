"""Mixtral-8x7B [arXiv:2401.04088]. 8 experts top-2, sliding-window attn."""
from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    n_experts=8, top_k=2, expert_d_ff=14336,
    swa_window=4096, rope_theta=1e6,
)
REDUCED = reduced(CONFIG)
