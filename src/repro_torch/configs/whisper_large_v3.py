"""Whisper large-v3 [arXiv:2212.04356]. Encoder-decoder; conv frontend is a
STUB: input_specs() provides precomputed (post-conv) frame embeddings.
Encoder is fixed at 1500 frames (30s of audio); decoder scales with the
shape's seq_len."""
from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab_size=51866,
    enc_dec=True, enc_layers=32, enc_len=1500,
    act="gelu", rope_theta=0.0,  # whisper uses learned/sinusoidal positions
)
REDUCED = reduced(CONFIG, n_kv_heads=4)
