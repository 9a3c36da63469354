"""Granite-20B code model [arXiv:2405.04324]. llama-arch, MQA (kv=1)."""
from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, rope_theta=10000.0,
)
REDUCED = reduced(CONFIG, n_kv_heads=1)
