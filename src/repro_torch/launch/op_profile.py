"""Static cost profile of one step of the port: the counterpart of both
`repro.launch.hlo_profile` (``analyze``) and `repro.launch.hlo_stats`
(``collective_stats``, ``op_census``).

There is no HLO in PyTorch. `profile` instead runs the step once on
meta tensors (shapes and dtypes, no data, no device) under a
`TorchDispatchMode` of its own, and returns the reference's keys:

  * dot_flops   — `torch.utils.flop_counter`'s formulas over the ops
                  (2 * m * n * k a matrix product), as its
                  `FlopCounterMode` counts them, plus the products of the
                  hand kernels below;
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
  * op_census   — calls by ATen op (and by hand kernel and collective),
                  the 24 most (`hlo_stats.op_census` counts HLO ops);
  * collectives — by kind, the count and the operand, result and wire
                  bytes of `distributed.meshes`' collectives, with the
                  reference's formulas (`hlo_profile.analyze`); empty on
                  one card, as are the collective bytes.

`profile_mesh` counts a step over a `distributed.meshes.Mesh` per
position: one position of each class at a time (`meshes.Count`; the
classes are the caller's, `distributed.spmd.classes`), each with the
keys above for that position alone, its ``argument_size_bytes`` the
bytes of its pieces (`meshes.nbytes_per_position`), and the positions
its class stands for. Each collective records itself at the counted
position and does not copy or sum (`meshes` notes on the count); its
operand and result bytes are added to ``hbm_bytes`` as an HLO
collective's are.

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
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import meshes as M
from repro_torch.kernels import ops

# ops that move no bytes: they allocate, or relabel a storage
_NO_TRAFFIC = frozenset({"empty", "empty_strided", "empty_like",
                         "detach", "alias", "lift_fresh", "_unsafe_view",
                         "set_", "resize_"})


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of ``tree``, a placed tensor's pieces among them."""
    out = []
    for t in tree_leaves(tree, is_leaf=M.is_placed):
        if M.is_placed(t):
            out.extend(p for p in t.pieces if p is not None)
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _flat(x, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results, in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, out)
    return out


_DECOMPOSES: Dict[Any, bool] = {}


def _decomposes(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd decomposition
    (`OpOverload.decompose`'s test)."""
    if func not in _DECOMPOSES:
        key = torch._C.DispatchKey.CompositeImplicitAutograd
        _DECOMPOSES[func] = (key in func.py_kernels or
                             torch._C._dispatch_has_kernel_for_dispatch_key(
                                 func.name(), key))
    return _DECOMPOSES[func]


class _Flops(TorchDispatchMode):
    """The products of a decomposed op's parts, as `FlopCounterMode`
    counts an op that has no formula of its own."""

    def __init__(self, walk):
        super().__init__()
        self.walk = walk

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self.walk._run(func, args, kwargs or {}, self)


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
        self.dot_flops = 0.0
        self.kernel_dot_flops = 0.0
        self.census: Counter = Counter()
        self.collectives: Dict[str, Dict[str, float]] = {}
        self.live = self.peak = 0
        self._alive: Dict[int, int] = {}
        self._flops = _Flops(self)
        self._arguments = {t.untyped_storage()._cdata
                           for t in _tensors(arguments)}

    def _free(self, key: int) -> None:
        self.live -= self._alive.pop(key)

    def _track(self, out) -> None:
        for t in _flat(out, []):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._alive or key in self._arguments:
                continue
            self._alive[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _run(self, func, args, kwargs, flops_mode):
        """``func``'s result and its products' FLOPs: its formula's, else
        (where it decomposes) its parts' under ``flops_mode``."""
        packet = func.overloadpacket
        formula = flop_registry.get(packet)
        if formula is None and _decomposes(func):
            with flops_mode:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if formula is not None:
            self.dot_flops += formula(*args, **kwargs, out_val=out)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs, self._flops)
        name = func.overloadpacket.__name__
        self.census[name] += 1
        if not (func.is_view or name in _NO_TRAFFIC):
            self.hbm_bytes += sum(map(_nbytes, _flat((args, kwargs), [])))
            self.hbm_bytes += sum(map(_nbytes, _flat(out, [])))
        self._track(out)
        return out

    def record(self, name: str, cost, device) -> List[torch.Tensor]:
        dot, nbytes, outs = cost
        self.kernel_dot_flops += dot
        self.hbm_bytes += nbytes
        self.census[name] += 1
        return [torch.empty(s, dtype=dt, device=device) for s, dt in outs]

    def collective(self, _position: int, kind: str, g: int,
                   result: float) -> None:
        """One collective of ``kind`` over ``g`` positions with ``result``
        bytes at the counted position: its operand and wire bytes by the
        reference's formulas (`hlo_profile.analyze`)."""
        if kind == "all-gather":
            operand, wire = result / g, result * (g - 1) / g
        elif kind == "all-reduce":
            operand, wire = result, 2.0 * result * (g - 1) / g
        elif kind == "reduce-scatter":
            operand = result * g
            wire = operand * (g - 1) / g
        elif kind == "all-to-all":
            operand, wire = result, result * (g - 1) / g
        else:                                   # collective-permute
            operand = wire = result
        c = self.collectives.setdefault(kind, {
            "operand_bytes": 0.0, "result_bytes": 0.0, "wire_bytes": 0.0,
            "count": 0.0})
        c["operand_bytes"] += operand
        c["result_bytes"] += result
        c["wire_bytes"] += wire
        c["count"] += 1
        self.census[kind] += 1
        self.hbm_bytes += operand + result

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
    return _count(fn, args, kwargs, None)


def _count(fn: Callable, args, kwargs, count) -> Dict[str, Any]:
    """`profile`; with ``count`` (a `meshes.Count`, open) its
    collectives record into the walk."""
    walk = _Walk((args, kwargs))
    if count is not None:
        count.record = walk.collective
    t0 = time.perf_counter()
    ops.COUNTER = walk
    try:
        with walk:
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
    colls = {k: dict(v) for k, v in walk.collectives.items()}
    return {
        "dot_flops": float(walk.dot_flops + walk.kernel_dot_flops),
        "hbm_bytes": walk.hbm_bytes,
        "peak_bytes": walk.peak,
        "memory": {"argument_size_bytes": arg_bytes,
                   "output_size_bytes": out_bytes,
                   "temp_size_bytes": max(walk.peak - sum(made.values()),
                                          0)},
        "collectives": colls,
        "collective_operand_bytes": sum(
            (v["operand_bytes"] for v in colls.values()), 0.0),
        "collective_wire_bytes": sum(
            (v["wire_bytes"] for v in colls.values()), 0.0),
        "op_census": dict(census),
        "n_ops": int(sum(walk.census.values())),
        "count_s": seconds,
        "result": result,
    }


def profile_mesh(build: Callable[[], Tuple[Callable, tuple]],
                 mesh: "M.Mesh", classes: Sequence[Sequence[int]]
                 ) -> List[Dict[str, Any]]:
    """The profile of a step over ``mesh`` at one position of each class
    of ``classes`` (lists of positions, mesh order; each class's first
    counted). ``build()`` returns (the step, its arguments) and is called
    under the count, so that it places the counted position's pieces
    only. Each entry has `profile`'s keys (no "result") for that position
    and ``"positions"``, the class; ``count_s`` includes the build."""
    out = []
    for members in classes:
        i = members[0]
        t0 = time.perf_counter()
        count = M.Count(mesh, (i,))
        M.COUNT = count
        try:
            fn, args = build()
            prof = _count(fn, args, {}, count)
        finally:
            M.COUNT = None
        del prof["result"]
        prof["memory"]["argument_size_bytes"] = \
            M.nbytes_per_position(args)[i]
        prof["count_s"] = time.perf_counter() - t0
        prof["positions"] = list(members)
        out.append(prof)
    return out
