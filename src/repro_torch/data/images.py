"""Deterministic synthetic image set standing in for BSD500.

A fixed, seeded set of natural-image-like test images (low-frequency
gratings + soft shapes + texture noise), generated with NumPy exactly as
`repro.data.images` does, so both packages label on the same pixels.
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=8)
def image_set(n: int = 8, size: int = 64, seed: int = 500) -> np.ndarray:
    """Returns (n, size, size, 3) uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    imgs = []
    for _ in range(n):
        base = np.zeros((size, size, 3), np.float32)
        for _ in range(3):  # low-frequency gratings
            fx, fy = rng.uniform(0.5, 4, 2)
            ph = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(20, 60)
            wave = amp * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
            base += wave[..., None] * rng.uniform(0.4, 1.0, 3)
        for _ in range(4):  # soft shapes (disks)
            cy, cx = rng.uniform(0.1, 0.9, 2)
            r = rng.uniform(0.05, 0.3)
            mask = ((yy - cy) ** 2 + (xx - cx) ** 2) < r ** 2
            base[mask] += rng.uniform(-70, 70, 3)
        base += rng.normal(0, 6, base.shape)          # texture noise
        base = base - base.min()
        base = base / max(base.max(), 1e-6) * 255.0
        imgs.append(base)
    return np.stack(imgs).astype(np.uint8)


def gray(images: np.ndarray) -> np.ndarray:
    w = np.array([0.299, 0.587, 0.114], np.float32)
    return (images.astype(np.float32) @ w).astype(np.int32)
