"""Wrapper of the CUDA kernel ``csrc/lut_eval.cu``: the int32 gather
``lut[(a << wb) | b]`` of the batched functional model."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = build.LaunchCounter()


def _declare(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.lut_eval_launch.argtypes = [p, ctypes.c_longlong, p, p, p,
                                    ctypes.c_longlong, ctypes.c_int, p]
    lib.lut_eval_launch.restype = ctypes.c_int


def lut_eval(lut: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             wb: int) -> torch.Tensor:
    """Launch the kernel. lut: (n,) int32; a, b: (M,) int32, all
    contiguous on one CUDA device -> (M,) int32."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"lut_eval kernel needs CUDA tensors, got {dev}")
    for name, t in (("lut", lut), ("a", a), ("b", b)):
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError(f"lut_eval: {name} must be int32 on {dev}, "
                             f"got {t.dtype} on {t.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"lut_eval: {name} must be a contiguous 1-D "
                             f"tensor, got shape {tuple(t.shape)}")
    if a.shape != b.shape:
        raise ValueError(f"lut_eval: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} differ")
    if lut.shape[0] < 1 or not 0 <= int(wb) < 31:
        raise ValueError(f"lut_eval: empty table or wb={wb} outside [0, 31)")
    out = torch.empty_like(a)
    if a.shape[0] == 0:
        return out
    lib = build.load("lut_eval", _declare)
    with torch.cuda.device(dev):
        err = lib.lut_eval_launch(
            lut.data_ptr(), lut.shape[0], a.data_ptr(), b.data_ptr(),
            out.data_ptr(), a.shape[0], int(wb),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lut_eval kernel launch failed: CUDA error {err}")
    LAUNCHES.add()
    return out
