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
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
