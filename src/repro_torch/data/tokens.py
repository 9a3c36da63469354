"""Deterministic synthetic token pipeline (NumPy).

The port's copy of `repro.data.tokens`: stateless ``batch_at(step)``
indexing (a restart replays the same batches), and a learnable structure
(a noisy affine bigram walk) so that training loss falls. Tokens and
labels are the reference's bit for bit: the same generator, seeded the
same way, drawn in the same order.

``extras`` maps an input's name to ``(shape, dtype)`` (the reference
takes ``ShapeDtypeStruct``s); the dtype is a torch or NumPy dtype or its
name. Integer extras are drawn as integers below ``max(seq_len, 2)``,
floating ones as standard normals, in the order given, continuing the
tokens' generator as the reference does. NumPy has no bfloat16: a
bfloat16 extra comes back as float32 holding the values rounded to
bfloat16 straight from the float64 draw (nearest, ties to even), the
values the reference's ``astype(bfloat16)`` gives.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def round_to_bfloat16(x: np.ndarray) -> np.ndarray:
    """float64 -> the nearest bfloat16 value (ties to even), as float32."""
    bits = np.ascontiguousarray(x, np.float64).view(np.uint64)
    drop = np.uint64(52 - 7)                  # bfloat16 keeps 7 of 52 bits
    lsb = (bits >> drop) & np.uint64(1)
    bits = bits + (np.uint64(1) << (drop - np.uint64(1))) - np.uint64(1) \
        + lsb
    bits &= ~((np.uint64(1) << drop) - np.uint64(1))
    return bits.view(np.float64).astype(np.float32)


@dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed << 20) ^ step)

    def batch_at(self, step: int, extras: Optional[Dict] = None
                 ) -> Dict[str, np.ndarray]:
        """Deterministic batch for `step` (restart-safe): int32 tokens
        (B,S) and labels (the next token; -1 at the last position)."""
        rng = self._rng(step)
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        a = 31 % V or 1
        start = rng.integers(0, V, (B, 1))
        noise = rng.integers(0, max(V // 64, 2), (B, S))
        # affine-bigram walk: t_{i+1} = (a * t_i + eps) mod V
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = start[:, 0]
        for i in range(1, S):
            toks[:, i] = (a * toks[:, i - 1] + noise[:, i]) % V
        tokens = toks.astype(np.int32)
        labels = np.concatenate([tokens[:, 1:],
                                 np.full((B, 1), -1, np.int32)], 1)
        out = {"tokens": tokens, "labels": labels}
        for k, (shape, dtype) in (extras or {}).items():
            if k in out:
                continue
            name = _dtype_name(dtype)
            if name.startswith(("int", "uint")):
                out[k] = rng.integers(0, max(self.seq_len, 2),
                                      shape).astype(name)
            elif name == "bfloat16":
                out[k] = round_to_bfloat16(rng.standard_normal(shape))
            else:
                out[k] = rng.standard_normal(shape).astype(name)
        return out
