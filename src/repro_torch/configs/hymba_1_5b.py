"""Hymba-1.5B [arXiv:2411.13676]. Hybrid-head: parallel attention + mamba
heads in every layer; SWA in most layers, global attention every 8th."""
from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, swa_window=1024, global_attn_every=8, rope_theta=10000.0,
)
REDUCED = reduced(CONFIG, n_heads=4, n_kv_heads=2, global_attn_every=2)
