"""Wrapper of the CUDA kernel ``csrc/ssm_scan.cu``: the diagonal linear
recurrence y_t = a_t * y_{t-1} + b_t over D float32 channels."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = build.LaunchCounter()


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssm_scan_launch.argtypes = [p, ll, i, p, p, p, p, i, ll, p]
    lib.ssm_scan_launch.restype = i


def repeat_factor(a: torch.Tensor, b: torch.Tensor) -> int:
    """R such that `a` (T, D/R) is shared by R neighbouring channels of
    b (T, D); raises if the shapes do not fit."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0] \
            or a.shape[1] == 0 or b.shape[1] % a.shape[1]:
        raise ValueError(f"ssm_scan: a must be (T, D) or (T, D/R) beside "
                         f"b (T, D); got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    return b.shape[1] // a.shape[1]


def ssm_scan(a: torch.Tensor, b: torch.Tensor, y0: torch.Tensor):
    """Launch the kernel. b: (T,D); a: (T,D), or (T,D/R) with channel c
    reading column c // R; y0: (D,). All contiguous float32 on one CUDA
    device. Returns ys (T,D) and y_final (D,)."""
    dev = b.device
    if dev.type != "cuda":
        raise ValueError(f"ssm_scan kernel needs CUDA tensors, got {dev}")
    for name, t in (("a", a), ("b", b), ("y0", y0)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"ssm_scan: {name} must be float32 on {dev}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} must be contiguous")
    rep = repeat_factor(a, b)
    T, D = b.shape
    if tuple(y0.shape) != (D,):
        raise ValueError(f"ssm_scan: y0 must be ({D},), got "
                         f"{tuple(y0.shape)}")
    if -(-D // 256) >= 2 ** 31:
        raise ValueError(f"ssm_scan: {D} channels exceed one launch's grid")
    ys = torch.empty_like(b)
    yf = torch.empty_like(y0)
    if D == 0:
        return ys, yf
    lib = build.load("ssm_scan", _declare)
    with torch.cuda.device(dev):
        err = lib.ssm_scan_launch(
            a.data_ptr(), a.shape[1], rep, b.data_ptr(), y0.data_ptr(),
            ys.data_ptr(), yf.data_ptr(), T, D,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES.add()
    return ys, yf
