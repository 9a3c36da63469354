"""RWKV-6 (Finch) 3B [arXiv:2404.05892]. Attention-free, data-dependent
per-channel decay; constant-size recurrent state."""
from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab_size=65536,
    attn_free=True, head_dim=64, ssm_state=64,
)
REDUCED = reduced(CONFIG, head_dim=16, ssm_state=16)
