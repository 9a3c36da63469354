"""Parameter tables and elementary layers of the LM stack, in PyTorch.

The port of `repro.models.layers`. Parameters live in nested dicts of
tensors whose paths and stacked leading ``L`` axis are the reference's
(``blocks/attn/wq`` is (L, d, H*hd) in both), so weights carry across
unchanged (`params_from_numpy`). Every parameter is declared with the
reference's *logical axis names* (`ParamTable.logical_axes`), which
`distributed.meshes.param_shardings` maps to mesh axes, so the same
declaration serves one card and a (data, model) mesh.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.device import DeviceLike
from repro_torch.kernels import ops
from repro_torch.spans import span

Initializer = str  # "normal" | "zeros" | "ones" | "embed"
# float32 elements of a normal leaf drawn at once by `ParamTable.init`
DRAW_ELEMS = 1 << 26

# Logical axis vocabulary (the reference's; `distributed.meshes` maps it):
#   "layers"  : stacked layer dim (never sharded)
#   "embed"   : d_model dims             -> fsdp ("data") axis
#   "vocab"   : vocabulary dim           -> "model" axis
#   "heads"   : flattened n_heads*hd dim -> "model" axis
#   "kv"      : flattened n_kv*hd dim    -> "model" axis
#   "ff"      : feed-forward hidden dim  -> "model" axis
#   "experts" : MoE expert dim           -> "model" axis (if divisible)
#   None      : replicated

PROD_MODEL_AXIS = 16   # "model" axis size on the production meshes


def head_axis(n_heads: int) -> str:
    """Logical axis of a flat (n_heads*head_dim) dim: "heads" when the
    head count divides the production model axis, else "heads_flat"
    (which the tensor-parallel rules replicate)."""
    return "heads" if n_heads % PROD_MODEL_AXIS == 0 else "heads_flat"


def kv_axis(n_kv_heads: int) -> str:
    """The same choice for a flat (n_kv_heads*head_dim) dim."""
    return "kv" if n_kv_heads % PROD_MODEL_AXIS == 0 else "kv_flat"


class ParamTable:
    """Declarative parameter registry: path -> (shape, init, scale), and
    path -> logical axes (`axes`)."""

    def __init__(self):
        self.defs: Dict[str, Tuple[Tuple[int, ...], Initializer, float]] = {}
        self.axes: Dict[str, Tuple[Optional[str], ...]] = {}

    def add(self, path: str, shape: Sequence[int],
            axes: Optional[Sequence[Optional[str]]] = None,
            init: Initializer = "normal", scale: Optional[float] = None):
        """Declare ``path``; ``axes`` names each dim's logical axis (None
        for every dim: replicated)."""
        axes = (None,) * len(shape) if axes is None else tuple(axes)
        assert len(shape) == len(axes), (path, shape, axes)
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        self.defs[path] = (tuple(int(s) for s in shape), init, scale)
        self.axes[path] = axes

    def shapes(self, dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
        """The tree of parameters as meta tensors of ``dtype`` (shapes
        only, no storage)."""
        out: Dict[str, Any] = {}
        for path, (shape, _k, _s) in sorted(self.defs.items()):
            _assign(out, path, torch.empty(shape, dtype=dtype,
                                           device="meta"))
        return out

    def logical_axes(self) -> Dict[str, Any]:
        """The tree of logical axes (a tuple per leaf), in the structure
        of `shapes`."""
        out: Dict[str, Any] = {}
        for path in sorted(self.defs):
            _assign(out, path, self.axes[path])
        return out

    def init(self, gen: torch.Generator, device: DeviceLike = None,
             dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
        """Random parameters from ``gen``, in the reference's distribution
        (normal x 1/sqrt(fan_in); ``embed`` at its own scale; zeros and
        ones as declared), stored in ``dtype`` on ``device``
        (`repro_torch.device.resolve`: the card unless ``device`` says
        otherwise). A normal leaf is drawn in float32 on ``gen``'s device
        in pieces of at most `DRAW_ELEMS` elements, in storage order, each
        written into the leaf before the next is drawn: no float32 copy of
        a whole leaf is made (Moonlight's expert weights are 33 GiB in
        float32). The numbers differ from the reference's threefry draw;
        parity tests carry the reference's weights over with
        `params_from_numpy`."""
        dev = device_lib.resolve(device)
        params: Dict[str, Any] = {}
        for path, (shape, kind, scale) in sorted(self.defs.items()):
            if kind == "zeros":
                arr = torch.zeros(shape, dtype=dtype, device=dev)
            elif kind == "ones":
                arr = torch.ones(shape, dtype=dtype, device=dev)
            else:
                arr = torch.empty(shape, dtype=dtype, device=dev)
                flat = arr.view(-1)
                for lo in range(0, flat.numel(), DRAW_ELEMS):
                    n = min(DRAW_ELEMS, flat.numel() - lo)
                    piece = torch.randn(n, generator=gen,
                                        dtype=torch.float32,
                                        device=gen.device).mul_(scale)
                    flat[lo:lo + n].copy_(piece)
            _assign(params, path, arr)
        return params


def _assign(tree: Dict[str, Any], path: str, value: Any) -> None:
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples (a
    NamedTuple keeps its type)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples in ``jax.tree``
    order: dict keys sorted, sequences (a NamedTuple too) in order, None
    an empty subtree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def params_from_numpy(tree, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None):
    """The port's parameters from a tree of NumPy arrays (the reference's
    parameters after ``np.asarray``), on ``device`` (the card unless it
    says otherwise). ``dtype`` casts every floating leaf; None keeps each
    leaf's own type (a bfloat16 leaf stays bfloat16)."""
    dev = device_lib.resolve(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":        # ml_dtypes: no torch view
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))   # a writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)
    return tree_map(leaf, tree)


# --------------------------------------------------------------------------
# elementary ops
# --------------------------------------------------------------------------

def fdot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weight matmul with float32 accumulation, the result in x's type.

    A bf16 product accumulates in float32 inside the library on both
    devices (cuBLAS's compute type; oneDNN on the CPU) and rounds once at
    the end, as the reference's ``preferred_element_type=float32`` does.
    On the card that holds only with split-K reductions in float32:
    `chip_smoke.py` sets
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    to False."""
    return torch.matmul(x, w.to(x.dtype)).to(x.dtype)


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in its own type where that is wider (a
    float64 run keeps float64 through the steps that compute in float32
    for narrower types)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * gamma over the last dimension
    (`kernels.ops.rms_norm`: the CUDA kernel on the card, the plain
    version on the CPU)."""
    with span("rms_norm"):
        return ops.rms_norm(x, gamma, eps)


def activation(name: str):
    """The MLP activation. GELU is the tanh approximation, as
    ``jax.nn.gelu`` computes it by default (``F.gelu``'s default is the
    exact erf form)."""
    return {"silu": F.silu, "relu": F.relu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def sinusoidal_at(positions: torch.Tensor, dim: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sinusoidal encoding of arbitrary positions, ``[sin | cos]``
    concatenated: positions (...,) int -> (..., dim). The Whisper decoder
    (rope_theta == 0) adds it at every step, so decode needs no table."""
    pos = positions.float()[..., None]
    half = dim // 2
    div = torch.exp(torch.arange(half, dtype=torch.float32,
                                 device=positions.device)
                    * (-math.log(10000.0) / half))
    ang = pos * div
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def sinusoidal_positions(length: int, dim: int, dtype: torch.dtype,
                         device: DeviceLike) -> torch.Tensor:
    """The Whisper encoder's table (length, dim): sin and cos
    interleaved (even and odd columns), computed in float64 NumPy and
    rounded to float32, as the reference computes it."""
    pos = np.arange(length)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-math.log(10000.0) / dim))
    pe = np.zeros((length, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(device=device, dtype=dtype)


# --------------------------------------------------------------------------
# rotary embeddings (standard + multimodal M-RoPE)
# --------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """positions: (B,S) int, or (B,S,3) for M-RoPE with ``sections``
    (frequency bands whose sizes sum to head_dim // 2; band i reads
    position column i % 3). Returns (B,S,head_dim//2) float32."""
    half = head_dim // 2
    inv_freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                       device=positions.device) / half)
    if sections:
        assert sum(sections) == half, (sections, half)
        pos = positions.float()
        chunks, start = [], 0
        for i, sec in enumerate(sections):
            chunks.append(pos[..., i % pos.shape[-1], None]
                          * inv_freq[start:start + sec])
            start += sec
        return torch.cat(chunks, dim=-1)
    return positions.float()[..., None] * inv_freq


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B,S,H,D); angles: (B,S,D//2)."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)
