"""Device meshes, logical-axis rules, and the leading-axis split.

The port of `repro.distributed.meshes`. A `Mesh` is an array of
`torch.device`s with named axes; its ``shape`` is the ordered
``{axis: size}`` of `jax.sharding.Mesh.shape`. The rule tables map the
LM's logical axes to mesh axes with the reference's divisibility
fallback (a dim is only sharded if the mesh axis divides it), and the
spec functions return the port's `PartitionSpec` (a tuple of axis names)
inside a `Placement`, where the reference returns a `NamedSharding`.

Baseline scheme ("fsdp2d"): parameters are 2-D sharded: d_model-like
dims over the "data" axis and output-feature dims (heads/ff/vocab/
experts) over the "model" axis. Activations shard batch over
("pod","data"); decode KV caches shard the sequence dim over "model".

`shard_leading_axis` is the split that the ApproxPilot main path uses:
the config rows of an engine chunk, the members of an ensemble, the
islands of a fleet. Its slices are independent, so each device computes
its slice with no communication and the gathered result equals the
unsplit one. One process holds the device list (single-controller): each
slice is copied to its device, every slice is dispatched before any is
collected, and the results are gathered on the primary device. A device
named several times in the list runs its slices one after another.

The LM over a mesh (`distributed.spmd`) holds its tensors placed:
`ShardedTensor` (a piece per mesh position, `place`, `gather`,
`map_placed`), the collectives over a named axis (`all_gather`,
`reduce_scatter`, `all_reduce`, `reshard`) and `sync_replicas`; notes
before `ShardedTensor`. Under a count (`COUNT`, `Count`) only the
counted positions hold pieces and the collectives record themselves.
"""
from __future__ import annotations

import functools
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import device as device_lib

# logical axis -> preferred mesh axis (baseline)
BASE_RULES: Dict[str, Any] = {
    "embed": "data",
    "vocab": "model",
    "heads": "model",
    "heads_flat": "model",   # baseline: shard the flat dim anyway
    "kv": "model",
    "kv_flat": "model",
    "ff": "model",
    "experts": "model",
    "layers": None,
    "state": None,
}

# Megatron-style tensor-parallel compute rules: weights are not sharded on
# the contraction ("embed") dim during compute, and attention weights whose
# head counts the model axis does not divide are replicated
TP_RULES = dict(BASE_RULES)
TP_RULES["embed"] = None
TP_RULES["heads_flat"] = None
TP_RULES["kv_flat"] = None

# TP compute with flat-sharded projections; context parallelism handles
# attention
CP_RULES = dict(TP_RULES)
CP_RULES["heads_flat"] = "model"
CP_RULES["kv_flat"] = "model"

PRESETS = {
    "baseline": {"storage": BASE_RULES, "compute": None},
    "tp": {"storage": BASE_RULES, "compute": TP_RULES},
    "serve8": {"storage": BASE_RULES, "compute": TP_RULES, "kv_int8": True},
    "kv8": {"storage": BASE_RULES, "compute": None, "kv_int8": True},
    "cp": {"storage": BASE_RULES, "compute": CP_RULES,
           "context_parallel": True},
}

# Flat (n_heads*head_dim)-style logical dims: sharding one is only safe
# when every device slice covers whole heads, so `spec_for(...,
# head_dim=...)` replicates when (dim // axis_size) % head_dim != 0
HEAD_FLAT_AXES = ("heads", "heads_flat", "kv", "kv_flat")


class PartitionSpec(tuple):
    """Mesh axis (a name, a tuple of names, or None) of each tensor dim.
    As in JAX, a tuple of one name is that name and an empty tuple is
    None."""

    def __new__(cls, *parts):
        def canon(p):
            if isinstance(p, tuple):
                return None if not p else (p[0] if len(p) == 1 else p)
            return p
        return super().__new__(cls, tuple(canon(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True, eq=False)
class Mesh:
    """An n-d array of devices with one name per axis. A device may appear
    more than once (the tests' ``[cpu] * 8``, one card named four
    times)."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        devs = np.empty(np.shape(self.devices), dtype=object)
        for i, d in np.ndenumerate(np.asarray(self.devices, dtype=object)):
            devs[i] = torch.device(d)
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if devs.ndim != len(self.axis_names):
            raise ValueError(f"{devs.ndim}-d device array for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> List[torch.device]:
        return list(self.devices.flat)


@dataclass(frozen=True)
class Placement:
    """Where a tensor lives: the counterpart of `NamedSharding`."""
    mesh: Mesh
    spec: PartitionSpec


def mesh_of(devices: Sequence, shape: Tuple[int, ...],
            axis_names: Tuple[str, ...]) -> Mesh:
    """A mesh of ``shape`` over ``devices`` in order."""
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return Mesh(arr.reshape(shape), axis_names)


# --------------------------------------------------------------------------
# logical axes -> specs
# --------------------------------------------------------------------------

def axis_size(mesh: Mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return int(np.prod([mesh.shape[n] for n in name]))
    return mesh.shape[name]


def maybe(mesh: Mesh, dim: int, name) -> Optional[Any]:
    """Return the mesh axis if `dim` divides evenly, else None."""
    if name is None or dim <= 1:
        return None
    if dim % axis_size(mesh, name) == 0:
        return name
    return None


def spec_for(mesh: Mesh, shape: Tuple[int, ...], axes: Tuple,
             rules: Dict[str, Any] = BASE_RULES,
             head_dim: Optional[int] = None) -> PartitionSpec:
    """The spec of a tensor of ``shape`` whose dims carry the logical
    ``axes``: each dim takes its rule's mesh axis when the axis divides it,
    the axis is not taken by an earlier dim, and (with ``head_dim``) a
    flat head dim splits into whole heads."""
    used = set()
    out = []
    for dim, logical in zip(shape, axes):
        want = rules.get(logical) if logical else None
        got = maybe(mesh, dim, want)
        if (got is not None and head_dim and logical in HEAD_FLAT_AXES
                and (dim // axis_size(mesh, got)) % head_dim != 0):
            got = None          # shard would split a head: replicate
        if got is not None:
            flat = got if isinstance(got, tuple) else (got,)
            if any(a in used for a in flat):
                got = None
            else:
                used.update(flat)
        out.append(got)
    return P(*out)


def _map_logical(fn, logical, shapes):
    """``fn(axes, leaf)`` over a logical-axes tree, whose tuples of axis
    names are its leaves, and the matching tree of shaped leaves."""
    if isinstance(logical, tuple):
        return fn(logical, shapes)
    if isinstance(logical, dict):
        return {k: _map_logical(fn, v, shapes[k]) for k, v in logical.items()}
    if isinstance(logical, list):
        return [_map_logical(fn, v, s) for v, s in zip(logical, shapes)]
    raise TypeError(f"unexpected logical-axes node {type(logical)}")


def param_shardings(mesh: Mesh, logical_tree, shape_tree,
                    rules: Dict[str, Any] = BASE_RULES,
                    head_dim: Optional[int] = None):
    """Map a tree of logical axes and the tree of shaped leaves (tensors,
    or anything with ``.shape``) to a tree of `Placement`s."""
    def one(axes, leaf):
        return Placement(mesh, spec_for(mesh, tuple(leaf.shape), axes, rules,
                                        head_dim=head_dim))
    return _map_logical(one, logical_tree, shape_tree)


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def data_sharding(mesh: Mesh, batch: int, ndim: int,
                  seq_axis_dim: Optional[int] = None,
                  seq_len: int = 0) -> Placement:
    """Batch-split activation/input placement with divisibility
    fallback."""
    ba = batch_axes(mesh)
    first = ba if batch % axis_size(mesh, ba) == 0 else (
        ("data",) if batch % mesh.shape.get("data", 1) == 0 else None)
    spec = [first if first else None] + [None] * (ndim - 1)
    if seq_axis_dim is not None and seq_len and \
            seq_len % mesh.shape.get("model", 1) == 0:
        spec[seq_axis_dim] = "model"
    return Placement(mesh, P(*spec))


def _cache_spec(mesh: Mesh, shp: Tuple[int, ...]) -> PartitionSpec:
    def b_at(i):
        return maybe(mesh, shp[i], batch_axes(mesh)) or \
            maybe(mesh, shp[i], "data")
    if len(shp) == 5:      # (L,B,W,KV,D) stacked kv cache
        return P(None, b_at(1), maybe(mesh, shp[2], "model"), None, None)
    if len(shp) == 4:      # per-layer (B,W,KV,D) hybrid cache
        return P(b_at(0), maybe(mesh, shp[1], "model"), None, None)
    if len(shp) == 2:      # (B,W) pos
        return P(b_at(0), maybe(mesh, shp[1], "model"))
    if len(shp) == 3:      # (L,B,d) rwkv shift carries
        return P(None, b_at(1), None)
    # (L,B,H,D,N) recurrent states
    return P(None, b_at(1), *([None] * (len(shp) - 2)))


def cache_shardings(mesh: Mesh, cache_tree):
    """Decode-cache placements: batch over (pod,data); seq dim over
    model. Leaves are tensors or anything with ``.shape``."""
    return pytree.tree_map(
        lambda leaf: Placement(mesh, _cache_spec(mesh, tuple(leaf.shape))),
        cache_tree)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, P())


# --------------------------------------------------------------------------
# the leading-axis split
# --------------------------------------------------------------------------

@dataclass
class Sharded:
    """A tree split along its leading axis: ``shards[i]`` is slice i,
    on ``mesh``'s device i. `gather` concatenates the slices back."""
    mesh: Mesh
    shards: List[Any]

    def gather(self, device=None):
        """The whole tree on ``device`` (default: the mesh's first
        device), each leaf the concatenation of its slices in order."""
        dst = torch.device(device) if device is not None \
            else self.mesh.device_list()[0]
        return pytree.tree_map(
            lambda *xs: torch.cat([x.to(dst) for x in xs]), *self.shards)


def split_count(n_leading: int, n_devices: int) -> int:
    """The largest device count, at most ``n_devices``, that divides
    ``n_leading`` (1 when only one does)."""
    for d in range(min(n_devices, n_leading), 0, -1):
        if n_leading % d == 0:
            return d
    return 1


def _slice_to(a, lo: int, hi: int, dev: torch.device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
    return t[lo:hi].to(dev, non_blocking=True)


def shard_leading_axis(tree, n_leading: int, axis_name: str = "shard",
                       max_devices: Optional[int] = None,
                       devices: Optional[Sequence] = None):
    """Split the leading axis of every tensor (or NumPy array) in ``tree``
    over devices.

    For programs whose leading-axis slices are independent (ensemble
    members, islands, an engine chunk's config rows) each device computes
    its slice with no communication, so per-slice results equal the
    unsplit run's. Uses the largest prefix of ``devices`` (default: every
    local device) whose size divides ``n_leading``, capped at
    ``max_devices``; returns ``tree`` unchanged when that prefix is one
    device, else a `Sharded` whose slice i is on device i (a copy issued
    without waiting; a view on the device the leaf already lives on)."""
    devs = list(devices) if devices is not None \
        else device_lib.local_devices()
    if max_devices is not None:
        devs = devs[:max(1, int(max_devices))]
    k = split_count(n_leading, len(devs))
    if k <= 1:
        return tree
    devs = [torch.device(d) for d in devs[:k]]
    n = n_leading // k
    shards = [pytree.tree_map(
        lambda a, i=i: _slice_to(a, i * n, (i + 1) * n, devs[i]), tree)
        for i in range(k)]
    return Sharded(mesh_of(devs, (k,), (axis_name,)), shards)


def data_parallel_mesh(min_devices: int = 1,
                       devices: Optional[Sequence] = None
                       ) -> Optional[Mesh]:
    """1-D ("data",) mesh over ``devices`` (default: every local device),
    for the sample-axis split of GNN training (`core.training`); None
    when fewer than ``min_devices`` devices are given."""
    devs = list(devices) if devices is not None \
        else device_lib.local_devices()
    if len(devs) < min_devices:
        return None
    return mesh_of(devs, (len(devs),), ("data",))


# --------------------------------------------------------------------------
# placed tensors and collectives over a named axis
# --------------------------------------------------------------------------
#
# The counterpart of a `jax.Array` with a `NamedSharding`: a `ShardedTensor`
# holds one piece per mesh position, in mesh order (row-major over the
# mesh's axes). A dim that the spec gives to axis ``a`` (or a tuple of
# axes) is cut into ``mesh.shape[a]`` equal blocks; the piece of a
# position is the block of its coordinate on that axis; replicated dims
# are whole. Each piece lives on its position's device, so a device named
# k times holds k pieces. A tensor may also be *partial* over some axes:
# its logical value is the sum of the pieces across those axes (the
# unreduced output of a row-parallel product, or per-device gradients).
#
# The collectives are single-controller: one process moves pieces between
# devices with copies and sums them in float32, always in mesh order, so a
# result is the same on every device of a group and does not depend on
# the order of work. All three are differentiable (autograd Functions):
# the transpose of a gather is a reduce-scatter, and the transpose of an
# all-reduce an all-reduce. NCCL would not serve here: it refuses two
# ranks on one card, and the tests name one CPU eight times.


@functools.lru_cache(maxsize=256)
def _positions(mesh: Mesh) -> Tuple[Dict[str, int], ...]:
    return tuple(dict(zip(mesh.axis_names, idx))
                 for idx in np.ndindex(*mesh.devices.shape))


def positions(mesh: Mesh) -> List[Dict[str, int]]:
    """Every position's coordinates ({axis: index}), in mesh order."""
    return [dict(c) for c in _positions(mesh)]


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def block_of(mesh: Mesh, spec: PartitionSpec, shape: Tuple[int, ...],
             coords: Dict[str, int]) -> Tuple[Tuple[int, int], ...]:
    """The (lo, hi) range of every dim that the position ``coords`` holds
    of a tensor of ``shape`` placed by ``spec`` (a tuple of axes splits
    row-major, the first axis outermost, as JAX's)."""
    out = []
    for k, dim in enumerate(shape):
        axes = _axes_of(spec[k]) if k < len(spec) else ()
        n, i = 1, 0
        for a in axes:
            i = i * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        if dim % n:
            raise ValueError(f"dim {k} of {tuple(shape)} does not split "
                             f"into {n} blocks over {axes}")
        size = dim // n
        out.append((i * size, (i + 1) * size))
    return tuple(out)


def _region(block, within) -> Tuple[slice, ...]:
    """Slices of ``block`` (global ranges) inside a piece holding
    ``within``."""
    return tuple(slice(lo - w0, hi - w0)
                 for (lo, hi), (w0, _w1) in zip(block, within))


def _overlap(a, b):
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


class ShardedTensor:
    """A tensor placed on a mesh (module notes above): ``pieces[i]`` is
    mesh position i's block, on that position's device (None at a
    position a count leaves out, `Count`). ``partial`` names the axes
    over which the pieces are unreduced summands."""

    def __init__(self, placement: Placement, shape: Sequence[int],
                 pieces: Sequence[torch.Tensor],
                 partial: Tuple[str, ...] = ()):
        self.placement = placement
        self.shape = torch.Size(shape)
        self.pieces = list(pieces)
        self.partial = tuple(partial)
        assert len(self.pieces) == placement.mesh.size

    @classmethod
    def from_pieces(cls, placement: Placement, pieces, partial=()):
        """The placed tensor whose pieces are ``pieces``; its logical shape
        is the first piece's times the split of each dim."""
        mesh, spec = placement.mesh, placement.spec
        shp = list(next(p for p in pieces if p is not None).shape)
        for k in range(len(shp)):
            if k < len(spec):
                shp[k] *= axis_size(mesh, spec[k])
        return cls(placement, shp, pieces, partial)

    @property
    def mesh(self) -> Mesh:
        return self.placement.mesh

    @property
    def spec(self) -> PartitionSpec:
        return self.placement.spec

    @property
    def first(self) -> torch.Tensor:
        """The first piece held (mesh order)."""
        return next(p for p in self.pieces if p is not None)

    @property
    def dtype(self) -> torch.dtype:
        return self.first.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def blocks(self) -> List[Tuple[Tuple[int, int], ...]]:
        return [block_of(self.mesh, self.spec, self.shape, c)
                for c in positions(self.mesh)]

    def gather(self, device=None) -> torch.Tensor:
        """The whole logical tensor on ``device`` (default: the mesh's
        first device); a partial tensor is summed (float32, mesh order)
        and returned in float32."""
        dst = torch.device(device) if device is not None \
            else self.mesh.device_list()[0]
        if self.partial:
            return all_reduce(self, self.partial).gather(dst)
        out = torch.empty(self.shape, dtype=self.dtype, device=dst)
        seen = set()
        for piece, blk in zip(self.pieces, self.blocks()):
            if blk not in seen:
                seen.add(blk)
                out[tuple(slice(lo, hi) for lo, hi in blk)].copy_(
                    piece.detach())
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, spec={self.spec}, "
                f"partial={self.partial})")


def place(tensor: torch.Tensor, placement: Placement,
          dtype: Optional[torch.dtype] = None) -> ShardedTensor:
    """``tensor`` cut into ``placement``'s pieces, each copied to its
    position's device (a distinct tensor per position, also where a
    device is named several times)."""
    mesh = placement.mesh
    shape = tuple(tensor.shape)
    devs, coords = mesh.device_list(), _positions(mesh)
    pieces: List[Optional[torch.Tensor]] = [None] * mesh.size
    for i in active(mesh):
        blk = block_of(mesh, placement.spec, shape, coords[i])
        piece = tensor[tuple(slice(lo, hi) for lo, hi in blk)]
        pieces[i] = piece.to(devs[i], dtype=dtype or tensor.dtype,
                             copy=True).contiguous()
    return ShardedTensor(placement, shape, pieces)


def map_placed(fn, *xs: ShardedTensor, placement: Optional[Placement] = None,
               partial: Optional[Tuple[str, ...]] = None) -> ShardedTensor:
    """``fn`` applied at every position to the pieces of ``xs`` (placed on
    one mesh); the result keeps the first's placement and partial axes
    unless given."""
    x0 = xs[0]
    pieces = [None if ps[0] is None else fn(*ps)
              for ps in zip(*(x.pieces for x in xs))]
    return ShardedTensor.from_pieces(
        placement or x0.placement, pieces,
        x0.partial if partial is None else partial)


def is_placed(x) -> bool:
    return isinstance(x, ShardedTensor)


def place_tree(tree, placements, dtype: Optional[torch.dtype] = None):
    """`place` over matching trees of tensors and `Placement`s."""
    if isinstance(tree, dict):
        return {k: place_tree(v, placements[k], dtype)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(place_tree(v, p, dtype)
                            for v, p in zip(tree, placements)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(v, p, dtype)
                          for v, p in zip(tree, placements))
    if is_placed(tree):
        return reshard(tree, placements, dtype)
    return place(tree, placements, dtype)


def nbytes_per_position(tree) -> List[int]:
    """Bytes each mesh position holds of the placed leaves of ``tree``
    (all on one mesh), in mesh order."""
    out: Optional[List[int]] = None
    for x in pytree.tree_leaves(tree, is_leaf=is_placed):
        if not is_placed(x):
            continue
        b = [0 if p is None else p.numel() * p.element_size()
             for p in x.pieces]
        out = b if out is None else [u + v for u, v in zip(out, b)]
    return out or []


def nbytes_per_device(tree) -> Dict[str, int]:
    """Bytes each device holds of the placed leaves of ``tree``; a device
    named k times counts its k positions' pieces."""
    out: Dict[str, int] = {}
    for x in pytree.tree_leaves(tree, is_leaf=is_placed):
        if not is_placed(x):
            continue
        for dev, p in zip(x.mesh.device_list(), x.pieces):
            if p is None:
                continue
            out[str(dev)] = out.get(str(dev), 0) + p.numel() * \
                p.element_size()
    return out


@functools.lru_cache(maxsize=256)
def _groups(mesh: Mesh, over: Tuple[str, ...]) -> List[List[int]]:
    """Positions grouped by their coordinates off the axes ``over``: each
    group lists the positions (mesh order) that differ only along
    ``over``."""
    keyed: "OrderedDict[tuple, List[int]]" = OrderedDict()
    for i, c in enumerate(positions(mesh)):
        key = tuple(v for a, v in c.items() if a not in over)
        keyed.setdefault(key, []).append(i)
    return list(keyed.values())


def _holder(coords: List[Dict[str, int]], devs, hs: List[int], i: int
            ) -> int:
    """The holder (among positions ``hs``) position i reads a block from:
    one on i's device that shares most of i's coordinates, else the one
    that shares most; the first in mesh order on ties."""
    def score(j):
        same = sum(coords[j][a] == v for a, v in coords[i].items())
        return (devs[j] == devs[i], same)
    best = max(score(j) for j in hs)
    return next(j for j in hs if score(j) == best)


@functools.lru_cache(maxsize=4096)
def _exchange_plan(mesh: Mesh, src_spec: PartitionSpec,
                   dst_spec: PartitionSpec, shape: Tuple[int, ...],
                   partial: Tuple[str, ...]):
    """What `_Exchange` moves, computed once per (mesh, specs, shape):
    the source and destination blocks, and for a non-partial source each
    destination's reads (source position, global region)."""
    coords = _positions(mesh)
    devs = mesh.device_list()
    sblk = tuple(block_of(mesh, src_spec, shape, c) for c in coords)
    dblk = tuple(block_of(mesh, dst_spec, shape, c) for c in coords)
    if partial:
        return sblk, dblk, _groups(mesh, partial), None
    holders: Dict[tuple, List[int]] = {}
    for j, b in enumerate(sblk):
        holders.setdefault(b, []).append(j)
    reads = []
    for i in range(len(devs)):
        for b, hs in holders.items():
            ov = _overlap(b, dblk[i])
            if ov is not None:
                reads.append((i, _holder(list(coords), devs, hs, i), ov))
    return sblk, dblk, None, tuple(reads)


def _sum_type(dtype: torch.dtype) -> torch.dtype:
    """The type a collective sums in: float32, or float64 for float64
    pieces."""
    return torch.promote_types(dtype, torch.float32)


class _Exchange(torch.autograd.Function):
    """Pieces of ``src`` -> pieces of the placement ``dst`` (not partial).

    Forward: every destination piece is assembled from the source: a
    non-partial source's blocks are copied from one holder each
    (`_holder`: its own piece, else a group peer's); a partial source is
    summed in float32 (`_sum_type`) over the destination's group (positions that differ
    only along the partial axes), once per group and block on the group's
    first device, and copied to the rest, so every device of a group
    holds the same values.
    Backward, the transpose: a non-partial source piece receives the
    float32 (`_sum_type`) sum, in mesh order, of the gradients of the destination
    regions read from it (the transpose of a gather is a reduce-scatter);
    a partial source piece receives the sum over its group's destination
    pieces (the transpose of an all-reduce is an all-reduce). The copies
    of a replicated block each receive what their own readers sent:
    `sync_replicas` sums them, as a parameter's replicas need."""

    @staticmethod
    def forward(ctx, src_meta, dst: Placement, dtype, *pieces):
        src_pl, shape, partial = src_meta
        mesh = src_pl.mesh
        devs = mesh.device_list()
        sblk, dblk, groups, reads = _exchange_plan(
            mesh, src_pl.spec, dst.spec, tuple(shape), tuple(partial))
        out: List[Optional[torch.Tensor]] = [None] * len(devs)
        if partial:
            for grp in groups:
                done: Dict[tuple, torch.Tensor] = {}
                for i in grp:
                    key = dblk[i]
                    if key not in done:
                        acc = None
                        for j in grp:        # mesh order
                            part = pieces[j][_region(key, sblk[j])].to(
                                devs[grp[0]], _sum_type(pieces[j].dtype))
                            acc = part if acc is None else acc + part
                        done[key] = acc
                    out[i] = done[key].to(devs[i], dtype or pieces[0].dtype,
                                          copy=True).contiguous()
        else:
            for i, dev in enumerate(devs):
                out[i] = torch.empty([hi - lo for lo, hi in dblk[i]],
                                     dtype=dtype or pieces[0].dtype,
                                     device=dev)
            for i, j, ov in reads:
                out[i][_region(ov, dblk[i])].copy_(
                    pieces[j][_region(ov, sblk[j])])
        ctx.meta = (mesh, partial, sblk, dblk, groups, reads,
                    [p.dtype for p in pieces])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        mesh, partial, sblk, dblk, groups, reads, dtypes = ctx.meta
        devs = mesh.device_list()
        acc: List[Optional[torch.Tensor]] = [None] * len(devs)

        def add(j, region, g):
            if acc[j] is None:
                acc[j] = torch.zeros([hi - lo for lo, hi in sblk[j]],
                                     dtype=_sum_type(g.dtype),
                                     device=devs[j])
            acc[j][_region(region, sblk[j])] += g.to(devs[j], acc[j].dtype)

        if partial:
            for grp in groups:
                for j in grp:
                    for i in grp:                   # mesh order
                        ov = _overlap(sblk[j], dblk[i])
                        if grads[i] is not None and ov is not None:
                            add(j, ov, grads[i][_region(ov, dblk[i])])
        else:
            for i, j, ov in reads:                  # mesh order of i
                if grads[i] is not None:
                    add(j, ov, grads[i][_region(ov, dblk[i])])
        gin = [None if a is None else a.to(dt)
               for a, dt in zip(acc, dtypes)]
        return (None, None, None, *gin)


def sync_replicas(x: ShardedTensor) -> ShardedTensor:
    """Sum, in place, the pieces that hold the same block (float32, mesh
    order) and give each copy the sum: the all-reduce of a replicated
    parameter's gradients over its copies."""
    if counting(x.mesh):
        holders = x.mesh.size // _n_blocks(x.mesh, x.spec)
        if holders > 1:
            for i in COUNT.active:
                COUNT.record(i, "all-reduce", holders, _nbytes(x.pieces[i]))
        return x
    with torch.no_grad():
        holders: Dict[tuple, List[int]] = {}
        for j, b in enumerate(x.blocks()):
            holders.setdefault(b, []).append(j)
        for hs in holders.values():
            if len(hs) < 2:
                continue
            first = x.pieces[hs[0]]
            tot = None
            for j in hs:
                t = x.pieces[j].to(first.device, torch.float32)
                tot = t if tot is None else tot + t
            for j in hs:
                x.pieces[j].copy_(tot)
    return x


def global_norm(xs: Sequence[ShardedTensor]) -> torch.Tensor:
    """The float32 L2 norm of the placed leaves ``xs`` together, each
    logical element once: a leaf's squared sum over one piece of each
    distinct block (mesh order), the leaves' sums added in their order on
    the mesh's first device. `optim.adamw.global_norm` of the gathered
    leaves, without a replicated block counted once per copy. Under a
    count each counted position squares and sums its own pieces and the
    sums are all-reduced over the mesh (a scalar)."""
    mesh = xs[0].mesh
    if counting(mesh):
        norms = []
        with torch.no_grad():
            for i in COUNT.active:
                total = torch.zeros((), dtype=torch.float32,
                                    device=xs[0].pieces[i].device)
                for x in xs:
                    total = total + x.pieces[i].float().square().sum()
                COUNT.record(i, "all-reduce", mesh.size, 4)
                norms.append(torch.sqrt(total))
        return norms[0]
    dev = mesh.device_list()[0]
    total = torch.zeros((), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for x in xs:
            leaf, seen = None, set()
            for piece, blk in zip(x.pieces, x.blocks()):
                if blk in seen:
                    continue
                seen.add(blk)
                s = piece.float().square().sum().to(dev)
                leaf = s if leaf is None else leaf + s
            total = total + leaf
    return torch.sqrt(total)


def reshard(x: ShardedTensor, placement: Placement,
            dtype: Optional[torch.dtype] = None) -> ShardedTensor:
    """``x`` on ``placement`` (cast to ``dtype`` on the way), through
    `_Exchange`; differentiable. A partial ``x`` is reduced. Returns ``x``
    itself when nothing moves."""
    if (not x.partial and _padded(placement.spec, x.ndim)
            == _padded(x.spec, x.ndim) and placement.mesh is x.mesh
            and (dtype is None or dtype == x.dtype)):
        return x
    pieces = _exchange(x, x.partial, placement, dtype)
    return ShardedTensor(placement, x.shape, pieces)


def _padded(spec: PartitionSpec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _without(spec: PartitionSpec, axis: str, dim: int) -> PartitionSpec:
    """``spec`` with ``axis`` taken off dim ``dim``."""
    parts = list(spec)
    parts[dim] = tuple(a for a in _axes_of(parts[dim]) if a != axis)
    return P(*parts)


def all_gather(x: ShardedTensor, axis: str, dim: int) -> ShardedTensor:
    """``x`` with dim ``dim`` whole across ``axis`` (which it was split
    over); the backward reduce-scatters."""
    if axis not in _axes_of(list(x.spec)[dim] if dim < len(x.spec)
                            else None):
        raise ValueError(f"dim {dim} of {x} is not split over {axis!r}")
    return reshard(x, Placement(x.mesh, _without(x.spec, axis, dim)))


def reduce_scatter(x: ShardedTensor, axis: str, dim: int,
                   dtype: Optional[torch.dtype] = None) -> ShardedTensor:
    """The sum of ``x``'s pieces over ``axis`` (``x`` partial over it),
    float32 in mesh order, with dim ``dim`` split over ``axis``; the
    backward all-gathers."""
    if axis not in x.partial:
        raise ValueError(f"{x} is not partial over {axis!r}")
    parts = list(x.spec) + [None] * (dim + 1 - len(x.spec))
    parts[dim] = _axes_of(parts[dim]) + (axis,)
    dst = Placement(x.mesh, P(*parts))
    pieces = _exchange(x, (axis,), dst, dtype or torch.float32)
    return ShardedTensor(dst, x.shape, pieces,
                         tuple(a for a in x.partial if a != axis))


def all_reduce(x: ShardedTensor, axis, dtype: Optional[torch.dtype] = None
               ) -> ShardedTensor:
    """The sum of ``x``'s pieces over ``axis`` (a name or a tuple of
    names, all among ``x.partial``), float32 in mesh order, the same on
    every device of each group (cast to ``dtype``, default float32);
    differentiable, the backward an all-reduce of the gradients."""
    axes = _axes_of(axis)
    if not set(axes) <= set(x.partial):
        raise ValueError(f"{x} is not partial over {axes}")
    pieces = _exchange(x, axes, x.placement, dtype or torch.float32)
    return ShardedTensor(x.placement, x.shape, pieces,
                         tuple(a for a in x.partial if a not in axes))


def _exchange(x: ShardedTensor, partial: Tuple[str, ...], dst: Placement,
              dtype: Optional[torch.dtype]) -> List[Optional[torch.Tensor]]:
    """The destination pieces of ``x`` (summed over ``partial``) on
    ``dst``: `_Exchange`, or under a count `_CountedExchange` at the
    counted positions."""
    meta = (x.placement, tuple(x.shape), tuple(partial))
    if not counting(x.mesh):
        return list(_Exchange.apply(meta, dst, dtype, *x.pieces))
    idx = COUNT.active
    outs = _CountedExchange.apply(meta, dst, dtype, idx,
                                  *[x.pieces[i] for i in idx])
    pieces: List[Optional[torch.Tensor]] = [None] * x.mesh.size
    for i, out in zip(idx, outs):
        pieces[i] = out
    return pieces


# --------------------------------------------------------------------------
# the count of a step over a mesh
# --------------------------------------------------------------------------
#
# `launch.op_profile.profile_mesh` counts a step over a mesh one position
# at a time: it sets `COUNT` to a `Count` of the mesh and the counted
# positions, places the step's arguments (`place` makes the counted
# positions' pieces only; every other piece is None) and runs the step on
# meta tensors. `distributed.spmd`'s per-position loops run the counted
# positions only (`active`). A collective does not copy or sum: at each
# counted destination it makes a piece of its block's shape, reading no
# other position, and records its kind, group size and result bytes
# (`Count.record`); its backward records the transpose. Where a
# destination's block lies inside its own source piece and nothing is
# summed, the exchange is local and its copy runs as an op, as outside
# the count. The kinds are the reference's HLO collectives
# (`hlo_profile`): all-gather (the block holds the own piece and g - 1
# others), reduce-scatter and all-reduce (a partial source, the block a
# 1/g part of the source piece or all of it), collective-permute (one
# other holder) and all-to-all (several). The group size g comes from the
# mesh axes the collective spans.

class Count:
    """A count of a step over ``mesh``: the positions ``active`` hold
    pieces; ``record(position, kind, group size, result bytes)`` takes
    each collective at a counted destination."""

    def __init__(self, mesh: Mesh, active: Sequence[int],
                 record: Optional[Callable] = None):
        self.mesh = mesh
        self.active = tuple(sorted(active))
        self.record = record or (lambda *a: None)


COUNT: Optional[Count] = None

# the collective whose work is the transpose of each kind's
TRANSPOSE = {"all-gather": "reduce-scatter", "reduce-scatter": "all-gather",
             "all-reduce": "all-reduce", "all-to-all": "all-to-all",
             "collective-permute": "collective-permute"}


def counting(mesh: Mesh) -> bool:
    """Whether a count of a step over ``mesh`` is open (`COUNT`)."""
    return COUNT is not None and COUNT.mesh is mesh


def active(mesh: Mesh) -> Sequence[int]:
    """The positions that hold pieces: every position, or those a count
    over ``mesh`` counts."""
    return COUNT.active if counting(mesh) else range(mesh.size)


def record(mesh: Mesh, i: int, kind: str, group: int,
           result: torch.Tensor) -> torch.Tensor:
    """Record, under a count over ``mesh``, a collective of ``kind`` over
    ``group`` positions whose result at position ``i`` is ``result`` (a
    piece made without reading another position); returns it."""
    if group > 1:
        COUNT.record(i, kind, group, _nbytes(result))
    return result


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sizes(block) -> List[int]:
    return [hi - lo for lo, hi in block]


def _inside(a, b) -> bool:
    return all(b0 <= a0 and a1 <= b1 for (a0, a1), (b0, b1) in zip(a, b))


def _n_blocks(mesh: Mesh, spec: PartitionSpec) -> int:
    """How many distinct blocks ``spec`` cuts a tensor into."""
    return int(np.prod([axis_size(mesh, e) for e in spec] or [1]))


@functools.lru_cache(maxsize=65536)
def _route(mesh: Mesh, src_spec: PartitionSpec, dst_spec: PartitionSpec,
           shape: Tuple[int, ...], partial: Tuple[str, ...], i: int
           ) -> Tuple[str, int]:
    """How an exchange makes position i's destination block: ("local", 1)
    when its own source piece holds the block and nothing is summed, else
    the collective's (kind, group size) (notes above)."""
    coords = _positions(mesh)
    src = block_of(mesh, src_spec, shape, coords[i])
    dst = block_of(mesh, dst_spec, shape, coords[i])
    ns, nd = int(np.prod(_sizes(src))), int(np.prod(_sizes(dst)))
    if partial:
        g = axis_size(mesh, tuple(partial))
        if g == 1:
            return "local", 1
        return ("reduce-scatter", g) if nd < ns else ("all-reduce", g)
    if _inside(dst, src):
        return "local", 1
    if _inside(src, dst) and nd % ns == 0:
        return "all-gather", nd // ns
    holders = {block_of(mesh, src_spec, shape, c) for c in coords}
    reads = [b for b in holders if _overlap(b, dst) is not None]
    if len(reads) == 1:
        return "collective-permute", 2
    return "all-to-all", len(reads)


class _CountedExchange(torch.autograd.Function):
    """`_Exchange` under a count, at the counted positions ``idx`` only:
    each destination piece is a copy of its own source piece where the
    exchange is local at it (`_route`), else an empty piece of its block
    and a recorded collective; backward the same, with the transpose's
    kind (`TRANSPOSE`) and the gradient's bytes."""

    @staticmethod
    def forward(ctx, src_meta, dst: Placement, dtype, idx, *pieces):
        src_pl, shape, partial = src_meta
        mesh = src_pl.mesh
        coords = _positions(mesh)
        outs, routes = [], []
        for i, piece in zip(idx, pieces):
            kind, g = _route(mesh, src_pl.spec, dst.spec, shape, partial, i)
            sblk = block_of(mesh, src_pl.spec, shape, coords[i])
            dblk = block_of(mesh, dst.spec, shape, coords[i])
            out = torch.empty(_sizes(dblk), dtype=dtype or piece.dtype,
                              device=piece.device)
            if kind == "local":
                out[_region(dblk, dblk)].copy_(piece[_region(dblk, sblk)])
            else:
                COUNT.record(i, kind, g, _nbytes(out))
            outs.append(out)
            routes.append((i, kind, g, sblk, dblk, piece.dtype))
        ctx.routes = routes
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        gin = []
        for (i, kind, g, sblk, dblk, dt), grad in zip(ctx.routes, grads):
            if grad is None:
                gin.append(None)
            elif kind == "local":
                acc = torch.zeros(_sizes(sblk), dtype=_sum_type(grad.dtype),
                                  device=grad.device)
                acc[_region(dblk, sblk)] += grad.to(acc.dtype)
                gin.append(acc.to(dt))
            else:
                COUNT.record(i, TRANSPOSE[kind], g,
                             int(np.prod(_sizes(sblk))) * grad.element_size())
                gin.append(torch.empty(_sizes(sblk), dtype=dt,
                                       device=grad.device))
        return (None, None, None, None, *gin)
