"""Moonlight-16B-A3B (kimi/moonshot) [hf:moonshotai/Moonlight-16B-A3B].
MoE: 64 experts, top-6, expert d_ff=1408."""
from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163840,
    n_experts=64, top_k=6, expert_d_ff=1408, rope_theta=50000.0,
)
REDUCED = reduced(CONFIG)
