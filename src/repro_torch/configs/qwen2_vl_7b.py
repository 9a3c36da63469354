"""Qwen2-VL-7B backbone [arXiv:2409.12191]. M-RoPE, dynamic-resolution vision
frontend is a STUB: input_specs() provides precomputed patch embeddings."""
from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, mrope_sections=(16, 24, 24), rope_theta=1e6,
    n_vision_tokens=256,
)
REDUCED = reduced(CONFIG, mrope_sections=(4, 2, 2))
