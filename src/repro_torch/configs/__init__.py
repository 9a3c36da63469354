"""Architecture registry: ``--arch <id>`` resolves through ARCHS.

A copy of the reference's registry (`repro.configs`), so that the port's
architecture names and shapes are the reference's own."""
from repro_torch.configs.base import (ArchConfig, ShapeConfig, SHAPES,
                                      TRAIN_4K, PREFILL_32K, DECODE_32K,
                                      LONG_500K, supports, reduced)
from repro_torch.configs import (qwen2_vl_7b, granite_3_2b, qwen2_5_32b,
                                 granite_20b, qwen1_5_110b, whisper_large_v3,
                                 moonshot_v1_16b_a3b, mixtral_8x7b,
                                 hymba_1_5b, rwkv6_3b)

_MODULES = (qwen2_vl_7b, granite_3_2b, qwen2_5_32b, granite_20b,
            qwen1_5_110b, whisper_large_v3, moonshot_v1_16b_a3b,
            mixtral_8x7b, hymba_1_5b, rwkv6_3b)

ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
REDUCED_ARCHS = {m.CONFIG.name: m.REDUCED for m in _MODULES}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]
