"""Wrapper of the CUDA kernel ``csrc/lut_eval.cu``: the int32 gather
``lut[(a << wb) | b]`` of the batched functional model, or ``lut[a]``
without b."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

LAUNCHES = build.LaunchCounter()
# the same launches by where the kernel reads the table (`path`)
ROUTE_LAUNCHES = {"shared": build.LaunchCounter(),
                  "global": build.LaunchCounter()}
# tables up to this size are staged into shared memory, one copy a block
# of the persistent grid (the 17 KB constant-coefficient columns are);
# the next size on the main paths, 272 KiB, exceeds a block's 227 KB
STAGE_MAX_BYTES = 96 * 1024


def _declare(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.lut_eval_launch.argtypes = [p, ctypes.c_longlong, p, p, p,
                                    ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int, p]
    lib.lut_eval_launch.restype = ctypes.c_int


def path(table_bytes: int) -> str:
    """Where the kernel reads a table of `table_bytes`: "shared" (staged
    once per block) or "global" (the read-only path and L2)."""
    return "shared" if table_bytes <= STAGE_MAX_BYTES else "global"


def check_b(b: Optional[torch.Tensor], wb: int) -> None:
    """`b=None` stands for b = 0, which only an index without b bits
    (wb == 0) can mean."""
    if b is None and wb != 0:
        raise ValueError(f"lut_eval: b=None needs wb == 0, got wb={wb}")


def lut_eval(lut: torch.Tensor, a: torch.Tensor,
             b: Optional[torch.Tensor] = None, wb: int = 0) -> torch.Tensor:
    """Launch the kernel. lut: (n,) int32; a and b (or None, meaning
    b = 0 with wb = 0): (M,) int32, all contiguous on one CUDA device ->
    (M,) int32."""
    check_b(b, wb)
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"lut_eval kernel needs CUDA tensors, got {dev}")
    named = [("lut", lut), ("a", a)] + ([] if b is None else [("b", b)])
    for name, t in named:
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError(f"lut_eval: {name} must be int32 on {dev}, "
                             f"got {t.dtype} on {t.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"lut_eval: {name} must be a contiguous 1-D "
                             f"tensor, got shape {tuple(t.shape)}")
    if b is not None and a.shape != b.shape:
        raise ValueError(f"lut_eval: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} differ")
    if not 1 <= lut.shape[0] < 2 ** 31 or not 0 <= int(wb) < 31 \
            or a.shape[0] >= 2 ** 40:
        raise ValueError(f"lut_eval: table of {lut.shape[0]} entries, "
                         f"{a.shape[0]} elements or wb={wb} outside [0, 31)")
    out = torch.empty_like(a)
    if a.shape[0] == 0:
        return out
    route = path(4 * lut.shape[0])
    lib = build.load("lut_eval", _declare)
    with torch.cuda.device(dev):
        err = lib.lut_eval_launch(
            lut.data_ptr(), lut.shape[0], a.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(),
            a.shape[0], int(wb), int(route == "shared"),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lut_eval kernel launch failed: CUDA error {err}")
    LAUNCHES.add()
    ROUTE_LAUNCHES[route].add()
    return out
