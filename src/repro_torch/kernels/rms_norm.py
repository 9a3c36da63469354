"""Wrapper of the CUDA kernel ``csrc/rms_norm.cu``: RMSNorm over the last
dimension, ``x * rsqrt(mean(x^2) + eps) * gamma`` in float32 (float64 for
float64 inputs), rounded once to x's type."""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

LAUNCHES = build.LaunchCounter()
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2,
          torch.float64: 3}
# threads a row while 8 loads a thread hold the row; more threads only
# past that
ROW_THREADS = 256
PER_THREAD = (1, 2, 4, 8)
MAX_THREADS = 1024


class Plan(NamedTuple):
    """One row's launch: `vec` elements a load (16 bytes, or 1 where a row
    is not on 16-byte boundaries), `per` loads a thread, `threads` a
    block (one block a row)."""
    vec: int
    per: int
    threads: int


def plan(d: int, element_size: int, aligned: bool) -> Plan:
    """The launch for rows of width ``d``: 16-byte loads where ``aligned``
    (every row's start, the output's and gamma's on 16-byte boundaries
    and d a multiple of the 16-byte vector), else one element a load; the
    fewest loads a thread that keep a row within ROW_THREADS threads (or,
    at 8 loads, within MAX_THREADS), the threads rounded up to whole
    warps."""
    vec = 16 // element_size if aligned else 1
    n = -(-d // vec)
    per = next((p for p in PER_THREAD if n <= p * ROW_THREADS),
               PER_THREAD[-1])
    threads = 32 * -(-n // (32 * per))
    if threads > MAX_THREADS:
        raise ValueError(f"rms_norm: a row of {d} elements "
                         f"({element_size} bytes each, "
                         f"{'16-byte' if aligned else 'scalar'} loads) "
                         f"exceeds {MAX_THREADS} threads x {per} loads")
    return Plan(vec, per, threads)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rms_norm_launch.argtypes = [p, ll, ll, p, p, i, i, i, i, i, i,
                                    ctypes.c_double, p]
    lib.rms_norm_launch.restype = i


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """Launch the kernel. x: (..., d) in bfloat16, float16, float32 or
    float64 on a CUDA device; gamma: (d,) of a floating type on the same
    device. Rows that cannot be viewed as (rows, d) with a unit last
    stride are copied contiguous first. Returns x's shape and type,
    contiguous."""
    if x.dtype not in DTYPES or not gamma.dtype.is_floating_point:
        raise ValueError(f"rms_norm: x in one of {list(DTYPES)} and a "
                         f"floating gamma, got {x.dtype} and {gamma.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if gamma.shape != (d,) or d == 0:
        raise ValueError(f"rms_norm: gamma {tuple(gamma.shape)} for rows "
                         f"of {tuple(x.shape)[-1:]}")
    dev = x.device
    if dev.type != "cuda" or gamma.device != dev:
        raise ValueError(f"rms_norm kernel needs x and gamma on one CUDA "
                         f"device, got {dev} and {gamma.device}")
    rows = x.numel() // d
    if rows >= 2 ** 31:
        raise ValueError(f"rms_norm: {rows} rows, the grid takes < 2^31")
    x2 = x.reshape(rows, d)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    # the plain version multiplies by gamma in the widened type: a gamma
    # of another type is widened here (d elements), one of x's is read as
    # it is
    if gamma.dtype != x.dtype:
        gamma = gamma.to(torch.promote_types(x.dtype, torch.float32))
    gamma = gamma.contiguous()
    out = torch.empty((rows, d), dtype=x.dtype, device=dev)
    if rows == 0:
        return out.view(x.shape)
    size = x.element_size()
    ld = x2.stride(0) if rows > 1 else d
    aligned = (d * size % 16 == 0 and ld * size % 16 == 0
               and (x2.data_ptr() | out.data_ptr() | gamma.data_ptr())
               % 16 == 0)
    pl = plan(d, size, aligned)
    lib = build.load("rms_norm", _declare)
    with torch.cuda.device(dev):
        err = lib.rms_norm_launch(
            x2.data_ptr(), rows, ld, gamma.data_ptr(), out.data_ptr(), d,
            DTYPES[x.dtype], int(gamma.dtype != x.dtype), pl.vec, pl.per,
            pl.threads, float(eps),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {err}")
    LAUNCHES.add()
    return out.view(x.shape)
