"""Static cost profile of one step of the port: the counterpart of both
`repro.launch.hlo_profile` (``analyze``) and `repro.launch.hlo_stats`
(``collective_stats``, ``op_census``).

There is no HLO in PyTorch. `profile` instead runs the step once on
meta tensors (shapes and dtypes, no data, no device) under a
`torch.utils.flop_counter.FlopCounterMode` and a `TorchDispatchMode` of
its own, and returns the reference's keys:

  * dot_flops   — the FlopCounterMode's count (2 * m * n * k a matrix
                  product), plus the products of the hand kernels below;
  * hbm_bytes   — the operand and result bytes of every ATen op, views
                  and bare allocations excepted: in eager mode every op
                  is a fusion boundary, so this is what the card's memory
                  sees when nothing stays in L2. An operand counts at
                  most its storage's size (an expanded tensor is read
                  once);
  * peak_bytes  — the most bytes held at once by storages made during
                  the step, from the live storages the mode tracks (a
                  storage is freed when its last tensor goes);
  * memory      — the dry run's {argument, output, temp}_size_bytes:
                  the arguments' storages, the result's storages, and
                  the peak less the result's storages made in the step;
  * op_census   — calls by ATen op (and by hand kernel), the 24 most
                  (`hlo_stats.op_census` counts HLO ops);
  * collectives — always empty on one card, as are the collective bytes
                  (`hlo_stats.collective_stats`).

The hand kernels (`kernels.ops`) are neither launched nor traced: while
a profile is open, `kernels.ops.COUNTER` is set and each call records the
kernel's own work and returns an output of the right shape and dtype.
The work is `chip_smoke.py`'s bound for each kernel, except that K3's
products count the full Sq x Sk score matrix, as the reference's plain
jnp attention computes it, causal or not; K4's scan adds bytes and no
products. Under autograd the output
carries a backward that records its own work: K3's input gradients are
the reference's jnp gradient, twice the forward's products; K4's backward
is one more scan plus the decay gradient's product, twice the forward's
work. Tracing the plain versions instead would count the plain K3's
float32 scores and the plain K4's Python loop over T.
"""
from __future__ import annotations

import time
import weakref
from collections import Counter
from typing import Any, Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops

# ops that move no bytes: they allocate, or relabel a storage
_NO_TRAFFIC = frozenset({"empty", "empty_strided", "empty_like",
                         "detach", "alias", "lift_fresh", "_unsafe_view",
                         "set_", "resize_"})


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """Bytes an op reads or writes of ``t``: its elements, at most its
    storage."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _storage_bytes(tree) -> int:
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


# --------------------------------------------------------------------------
# the hand kernels' work: (products' flops, bytes, output shapes/dtypes)
# --------------------------------------------------------------------------

def _gnn_mp(adj, h, w_self, w_nbr, b):
    B, N, F = h.shape
    Fo = w_self.shape[1]
    dot = 2 * B * N * F * Fo * 2 + 2 * B * N * N * Fo
    nbytes = sum(map(_nbytes, (adj, h, w_self, w_nbr, b))) + 4 * B * N * Fo
    return dot, nbytes, [((B, N, Fo), h.dtype)]


def _lut_eval(lut, a, b=None, wb: int = 0):
    per_elem = 4 + 4 + (4 if b is not None else 0)
    return (0, _nbytes(lut) + per_elem * a.numel(),
            [(tuple(a.shape), torch.int32)])


def _flash_attention(q, k, v, causal: bool = True):
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    dot = 4 * B * H * Sq * Sk * D
    nbytes = sum(map(_nbytes, (q, k, v))) + _nbytes(q)
    return dot, nbytes, [(tuple(q.shape), q.dtype)]


def _ssm_scan(a, b, y0):
    T, D = b.shape
    nbytes = _nbytes(a) + _nbytes(y0) + 2 * _nbytes(b) + 4 * D
    return 0, nbytes, [((T, D), b.dtype), ((D,), b.dtype)]


KERNELS: Dict[str, Callable] = {
    "gnn_mp": _gnn_mp, "lut_eval": _lut_eval,
    "flash_attention": _flash_attention, "ssm_scan": _ssm_scan}


class _Counted(torch.autograd.Function):
    """A hand kernel's call under autograd: empty outputs forward, empty
    input gradients backward, each direction's work recorded."""

    @staticmethod
    def forward(ctx, walk, name, cost, *inputs):
        ctx.walk, ctx.name, ctx.cost = walk, name, cost
        ctx.specs = [(tuple(t.shape), t.dtype, t.device) for t in inputs]
        outs = walk.record(name, cost, inputs[0].device)
        return tuple(outs) if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        dot, nbytes, _ = ctx.cost
        ctx.walk.record(ctx.name + "_backward", (2 * dot, 2 * nbytes, []),
                        None)
        return (None, None, None) + tuple(
            torch.empty(s, dtype=dt, device=dev) if need else None
            for (s, dt, dev), need in zip(ctx.specs,
                                          ctx.needs_input_grad[3:]))


class _Walk(TorchDispatchMode):
    """Counts every ATen op's bytes and the live storages made in the
    step; `record` takes a hand kernel's work (`kernels.ops.COUNTER`)."""

    def __init__(self, arguments):
        super().__init__()
        self.hbm_bytes = 0.0
        self.kernel_dot_flops = 0.0
        self.census: Counter = Counter()
        self.live = self.peak = 0
        self._alive: Dict[int, int] = {}
        self._arguments = {t.untyped_storage()._cdata
                           for t in _tensors(arguments)}

    def _free(self, key: int) -> None:
        self.live -= self._alive.pop(key)

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._alive or key in self._arguments:
                continue
            self._alive[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        self.census[name] += 1
        if not (func.is_view or name in _NO_TRAFFIC):
            self.hbm_bytes += sum(map(_nbytes, _tensors((args, kwargs))))
            self.hbm_bytes += sum(map(_nbytes, _tensors(out)))
        self._track(out)
        return out

    def record(self, name: str, cost, device) -> List[torch.Tensor]:
        dot, nbytes, outs = cost
        self.kernel_dot_flops += dot
        self.hbm_bytes += nbytes
        self.census[name] += 1
        return [torch.empty(s, dtype=dt, device=device) for s, dt in outs]

    def kernel(self, name: str, *args, **kwargs):
        """A call of ``kernels.ops.<name>``, counted, not run."""
        cost = KERNELS[name](*args, **kwargs)
        inputs = [t for t in args if isinstance(t, torch.Tensor)]
        if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
            return _Counted.apply(self, name, cost, *inputs)
        outs = self.record(name, cost, inputs[0].device)
        return tuple(outs) if len(outs) > 1 else outs[0]


def profile(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once under the count (the arguments
    are meta tensors, or trees of them) and return its profile; the
    result of ``fn`` under ``"result"``."""
    walk = _Walk((args, kwargs))
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    ops.COUNTER = walk
    try:
        with flops, walk:
            result = fn(*args, **kwargs)
    finally:
        ops.COUNTER = None
    seconds = time.perf_counter() - t0
    arg_bytes = _storage_bytes((args, kwargs))
    out_bytes = _storage_bytes(result)
    made = {}
    for t in _tensors(result):
        st = t.untyped_storage()
        if st._cdata not in walk._arguments:
            made[st._cdata] = st.nbytes()
    census = sorted(walk.census.items(), key=lambda kv: -kv[1])[:24]
    return {
        "dot_flops": float(flops.get_total_flops()) + walk.kernel_dot_flops,
        "hbm_bytes": walk.hbm_bytes,
        "peak_bytes": walk.peak,
        "memory": {"argument_size_bytes": arg_bytes,
                   "output_size_bytes": out_bytes,
                   "temp_size_bytes": max(walk.peak - sum(made.values()),
                                          0)},
        "collectives": {},
        "collective_operand_bytes": 0.0,
        "collective_wire_bytes": 0.0,
        "op_census": dict(census),
        "n_ops": int(sum(walk.census.values())),
        "count_s": seconds,
        "result": result,
    }
