"""Wrapper of the CUDA kernel ``csrc/flash_attention.cu``: causal or full
attention with grouped KV heads, in the reference kernel's (B,H,S,D)
layout, read and written through strides. Queries may be fewer than keys
(Sq <= Sk); the causal mask is then aligned bottom-right, query row i at
key position Sk - Sq + i."""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

LAUNCHES = build.LaunchCounter()
HEAD_DIMS = (16, 32, 64, 128)
MAX_BATCH_HEADS = 65535        # the float32 path's grid y extent
SMEM_PER_BLOCK = 232448        # an H100 block's dynamic shared memory
SWIZZLE_SPANS = (32, 64, 128)  # TMA/wgmma swizzle modes, bytes


@dataclass(frozen=True)
class Plan:
    """The bf16 kernel's launch for one head dim: `warpgroups` consumer
    warpgroups of 64 query rows (`bq` rows a work item) and a producer
    warpgroup; K/V tiles of `bk` keys in a ring of `stages`; TMA boxes of
    `box_cols` columns (`boxes` of them across D) swizzled by `swizzle`
    bytes."""
    head_dim: int
    warpgroups: int
    bq: int
    bk: int
    stages: int
    q_buffers: int
    threads: int
    box_cols: int
    boxes: int
    swizzle: int
    smem_bytes: int
    qk_wgmma: tuple             # (M, N, K) of S = Q K^T
    pv_wgmma: tuple             # (M, N, K) of O += P V

    def launch_args(self):
        """What the launcher checks against its compiled plan."""
        return (self.bq, self.bk, self.stages, self.threads,
                self.smem_bytes)


def plan(head_dim: int) -> Plan:
    """The launch plan of ``csrc/flash_attention.cu::Plan<D>`` (the C
    side refuses a launch whose plan differs): a box is at most one
    swizzle span (128 bytes) wide, so D = 128 is two boxes; shared memory
    holds Q, the K/V ring and the barriers on a 1024-byte boundary."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {head_dim}; the "
                         f"kernel takes {HEAD_DIMS}")
    warpgroups = 2 if head_dim == 128 else 3
    bq, bk = 64 * warpgroups, 128
    stages = 3
    box_cols = min(head_dim, 64)
    q_bytes = bq * head_dim * 2
    tile_bytes = bk * head_dim * 2
    # Q of two work items (one at D = 128, where the ring needs the room);
    # barriers: Q full/empty per buffer, K full, V full and empty per stage
    q_buffers = 1 if head_dim == 128 else 2
    smem = (1024 + q_buffers * q_bytes + 2 * stages * tile_bytes
            + 8 * (2 * q_buffers + 3 * stages))
    return Plan(head_dim=head_dim, warpgroups=warpgroups, bq=bq, bk=bk,
                stages=stages, q_buffers=q_buffers,
                threads=128 * (warpgroups + 1),
                box_cols=box_cols,
                boxes=head_dim // box_cols, swizzle=2 * box_cols,
                smem_bytes=smem, qk_wgmma=(64, bk, 16),
                pv_wgmma=(64, head_dim, 16))


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = (
        [p, p, p, p, i, i, i, i, i, i] + [ll] * 12 + [i, i, p, p])
    lib.flash_attention_launch.restype = i


def _bhs_strides(name: str, t: torch.Tensor):
    """(batch, head, sequence) strides of a (B,*,S,D) tensor whose rows the
    kernel reads 16 bytes at a time."""
    vec = 16 // t.element_size()
    st = t.stride()
    if st[3] != 1 or any(s % vec for s in st[:3]) or t.data_ptr() % 16:
        raise ValueError(
            f"flash_attention: {name} needs a unit last stride, 16-byte "
            f"aligned data and other strides that are multiples of {vec} "
            f"elements; got strides {st}")
    return st[:3]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Launch the kernel. q: (B,H,Sq,D); k, v: (B,KV,Sk,D) with H = KV*G
    and Sq <= Sk (under ``causal`` query row i sits at key position
    Sk - Sq + i); all bfloat16 or all float32 on one CUDA device, any
    strides with a unit last stride (a transposed view of a (B,S,H,D)
    tensor is read in place). Returns (B,H,Sq,D) in q's type and memory
    layout."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, "
                         f"got {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention: bfloat16 or float32, got "
                         f"{q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} must be {q.dtype} "
                             f"on {dev}, got {t.dtype} on {t.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B,H,Sq,D) and k, v "
                         f"(B,KV,Sk,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if (k.shape[0], k.shape[3]) != (B, D) or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} with H % KV == 0")
    if Sq > Sk:
        raise ValueError(f"flash_attention: {Sq} queries over {Sk} keys; "
                         f"the kernel takes Sq <= Sk")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D}; the kernel "
                         f"takes {HEAD_DIMS}")
    if B * H > MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention: B*H = {B * H} exceeds one "
                         f"launch's grid ({MAX_BATCH_HEADS})")
    out = torch.empty_like(q)
    if B * H * Sq == 0:
        return out
    strides = [*_bhs_strides("q", q), *_bhs_strides("k", k),
               *_bhs_strides("v", v), *_bhs_strides("out", out)]
    is_bf16 = q.dtype == torch.bfloat16
    launch_plan = (ctypes.c_int * 5)(
        *(plan(D).launch_args() if is_bf16 else (0,) * 5))
    lib = build.load("flash_attention", _declare)
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, Sq, Sk, D, *strides, int(bool(causal)), int(is_bf16),
            launch_plan, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        why = {-1: "the TMA tensor maps could not be built",
               -2: "the launch plan differs from the compiled kernel's"}
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{why.get(err, f'CUDA error {err}')}")
    LAUNCHES.add()
    return out
