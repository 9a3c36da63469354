"""Graph abstraction of approximate accelerators (Fig. 2 of the paper).

NumPy, as `repro.core.graph`: the same node merging, feature schemas and
padded dense batches, so both packages feed identical tensors to their
GNNs.

Each arithmetic-unit instance is a node; physical connections are edges.
Fixed components (memories, dividers, comparators...) are abstracted by
function and *merged* when, after abstraction, they share the same
incoming-neighbour set and outgoing-neighbour kinds — iterated to fixpoint,
which reproduces the paper's two-stage simplification (center mems + divs
collapse in kmeans).

The GNN consumes batched dense tensors: adjacency (B,N,N) with symmetric
normalization, features (B,N,F), mask (B,N).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.accel import library as lib
from repro_torch.accel.apps import AccelDef

# node-kind vocabulary for the one-hot feature (Table I "Compute Type")
KIND_VOCAB = ("add8", "add12", "add16", "sub10", "mul8", "mul8x4", "sqrt18",
              "mem", "div", "cmp", "abs", "shift")

# app-identity vocabulary for the cross-app unified surrogate: merged
# feature rows append a one-hot app block AFTER the per-node layout,
# so the merged feature dim is FEATURE_DIM + len(APP_VOCAB) regardless of
# which app subset is merged (leave-one-app-out training keeps the same
# parameter shapes, and the held-out app's column simply never fires).
APP_VOCAB = ("sobel", "gaussian", "kmeans", "dct8", "fir15")


# --------------------------------------------------------------------------
# versioned feature schema: the ONE owner of the node-feature layout
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class FeatureBlock:
    """A named, contiguous group of feature columns.

    ``normalize`` flags, per field, whether the column is standardized
    with the dataset x-stats (continuous magnitudes) or left raw (one-hot
    indicators and the stage-1 crit bit, which must stay exactly {0, 1}).
    """
    name: str
    fields: Tuple[str, ...]
    normalize: Tuple[bool, ...]

    def __post_init__(self):
        if len(self.fields) != len(self.normalize):
            raise ValueError(f"block {self.name!r}: {len(self.fields)} "
                             f"fields vs {len(self.normalize)} flags")

    @property
    def dim(self) -> int:
        return len(self.fields)


@dataclass(frozen=True)
class FeatureSchema:
    """Versioned node-feature layout: named blocks -> column indices.

    Every consumer of the feature tensor (`ConfigFeaturizer`,
    `dataset.merge`, `models.predict`, the engine's kernel path, the
    pipeline cache keys) derives its offsets from this object instead of
    hard-coding them, so growing the layout is a schema bump — not a hunt
    for scattered literals. The app one-hot block of the merged layout is
    NOT part of ``blocks``: it is appended by `app_block` and
    accounted in ``merged_dim``.
    """
    version: int
    blocks: Tuple[FeatureBlock, ...]

    @property
    def dim(self) -> int:
        return sum(b.dim for b in self.blocks)

    @property
    def merged_dim(self) -> int:
        return self.dim + len(APP_VOCAB)

    def block(self, name: str) -> FeatureBlock:
        for b in self.blocks:
            if b.name == name:
                return b
        raise KeyError(f"schema v{self.version} has no block {name!r}; "
                       f"blocks={[b.name for b in self.blocks]}")

    def start(self, name: str) -> int:
        off = 0
        for b in self.blocks:
            if b.name == name:
                return off
            off += b.dim
        raise KeyError(f"schema v{self.version} has no block {name!r}")

    def sl(self, name: str) -> slice:
        s = self.start(name)
        return slice(s, s + self.block(name).dim)

    def col(self, name: str, field: str) -> int:
        return self.start(name) + self.block(name).fields.index(field)

    @property
    def crit_index(self) -> int:
        """Column of the stage-1 on-critical-path bit."""
        return self.col("timing", "on_critical_path")

    @property
    def dynamic_fields(self) -> Tuple[str, ...]:
        """Config-dynamic timing fields filled by the batched timing
        oracle on the DSE hot path (everything in the timing block except
        the crit bit, which stage 1 predicts at inference).

        These columns are what makes featurization host work worth
        pipelining: under schema v2 every cold engine chunk pays a
        timing sweep + two-scale functional probe, which the engine's
        overlap mode (`SurrogateEngine`, ``overlap=True``) runs on a
        prefetch thread while the previous chunk executes on device."""
        return tuple(f for f in self.block("timing").fields
                     if f != "on_critical_path")

    @property
    def dynamic_slice(self) -> slice:
        """Contiguous columns of `dynamic_fields` (empty slice in v1)."""
        s = self.start("timing")
        fields = self.block("timing").fields
        if len(fields) == 1:
            return slice(s + 1, s + 1)
        return slice(s + 1, s + len(fields))

    def normalize_mask(self) -> np.ndarray:
        """(dim,) bool: True where the column is standardized with the
        dataset x-stats (see `dataset.build`)."""
        return np.concatenate(
            [np.asarray(b.normalize, bool) for b in self.blocks])


_UNIT_STATS = FeatureBlock(
    "unit_stats",
    ("area", "power", "latency", "mae", "mre", "mse", "wce",
     "approx_level"), (True,) * 8)
_KIND_ONEHOT = FeatureBlock("kind_onehot", KIND_VOCAB,
                            (False,) * len(KIND_VOCAB))

# v1 — the original layout: static unit stats + the oracle crit bit +
# kind one-hot. Kept so artifacts built before the schema refactor remain
# loadable and featurizable.
SCHEMA_V1 = FeatureSchema(1, (
    _UNIT_STATS,
    FeatureBlock("timing", ("on_critical_path",), (False,)),
    _KIND_ONEHOT))

# v2 — config-dynamic timing block: per-node normalized slack,
# path-position criticality (arrive/tmax), the log1p-compressed error
# mass (unit mae/wce accumulated along the DAG) from the batched
# timing-only oracle (`batch_oracle.timing_batch`), and the two-scale
# functional-probe distortion (1 - SSIM of the real batched functional
# model on tiny probe images, `batch_oracle.probe_batch`) broadcast as
# graph-level columns — the composed-error signal the per-unit profiles
# cannot carry (fixed coefficient operands, clips, adder trees).
SCHEMA_V2 = FeatureSchema(2, (
    _UNIT_STATS,
    FeatureBlock("timing",
                 ("on_critical_path", "slack", "criticality",
                  "err_mae", "err_wce", "probe_err8", "probe_err16"),
                 (False, True, True, True, True, True, True)),
    _KIND_ONEHOT))

SCHEMAS = {s.version: s for s in (SCHEMA_V1, SCHEMA_V2)}
ACTIVE_SCHEMA = SCHEMA_V2


def schema_for(version: Optional[int]) -> FeatureSchema:
    """Schema registry lookup; ``None`` means the active schema."""
    if version is None:
        return ACTIVE_SCHEMA
    try:
        return SCHEMAS[int(version)]
    except KeyError:
        raise KeyError(f"unknown feature-schema version {version!r}; "
                       f"known: {sorted(SCHEMAS)}") from None


# back-compat layout constants, derived from the active schema (new code
# should query the schema of the dataset/model it is working with)
FEATURE_DIM = ACTIVE_SCHEMA.dim
CRIT_IDX = ACTIVE_SCHEMA.crit_index
N_BASE = ACTIVE_SCHEMA.start("kind_onehot")
MERGED_FEATURE_DIM = ACTIVE_SCHEMA.merged_dim


def app_block(app_name: str, mask: np.ndarray) -> np.ndarray:
    """(..., N, len(APP_VOCAB)) one-hot app-identity block, masked so
    padding rows stay zero. ``mask`` is the (..., N) node mask."""
    if app_name not in APP_VOCAB:
        raise ValueError(f"unknown app {app_name!r}; APP_VOCAB={APP_VOCAB}")
    block = np.zeros(mask.shape + (len(APP_VOCAB),), np.float32)
    block[..., APP_VOCAB.index(app_name)] = mask
    return block


def with_app_block(x: np.ndarray, mask: np.ndarray,
                   app_name: str) -> np.ndarray:
    """Append the app-identity one-hot block to a feature tensor."""
    return np.concatenate([x, app_block(app_name, mask)],
                          axis=-1).astype(np.float32)


@dataclass(frozen=True)
class SimpleGraph:
    node_ids: Tuple[str, ...]
    kinds: Tuple[str, ...]
    fixed: Tuple[bool, ...]
    adj: np.ndarray           # (N,N) 0/1, directed
    merged_from: Tuple[Tuple[str, ...], ...]


def build_graph(app: AccelDef, simplify: bool = True) -> SimpleGraph:
    ids = [n.id for n in app.nodes]
    kind = {n.id: n.kind for n in app.nodes}
    fixed = {n.id: n.fixed for n in app.nodes}
    preds: Dict[str, set] = {i: set() for i in ids}
    succs: Dict[str, set] = {i: set() for i in ids}
    for u, v in app.edges:
        preds[v].add(u)
        succs[u].add(v)

    groups = {i: (i,) for i in ids}
    if simplify:
        changed = True
        while changed:
            changed = False
            sig: Dict[tuple, List[str]] = {}
            for i in ids:
                if not fixed[i]:
                    continue
                s = (kind[i], frozenset(preds[i]),
                     frozenset(kind[x] for x in succs[i]))
                sig.setdefault(s, []).append(i)
            for same in sig.values():
                if len(same) < 2:
                    continue
                keep, rest = same[0], same[1:]
                for r in rest:
                    for p in preds[r]:
                        succs[p].discard(r)
                        succs[p].add(keep)
                        preds[keep].add(p)
                    for s_ in succs[r]:
                        preds[s_].discard(r)
                        preds[s_].add(keep)
                        succs[keep].add(s_)
                    ids.remove(r)
                    groups[keep] = groups[keep] + groups[r]
                    del groups[r], preds[r], succs[r]
                changed = True

    n = len(ids)
    idx = {i: k for k, i in enumerate(ids)}
    adj = np.zeros((n, n), np.float32)
    for i in ids:
        for s_ in succs[i]:
            if s_ in idx:
                adj[idx[i], idx[s_]] = 1.0
    return SimpleGraph(tuple(ids), tuple(kind[i] for i in ids),
                       tuple(fixed[i] for i in ids), adj,
                       tuple(groups[i] for i in ids))


def normalized_adjacency(adj: np.ndarray) -> np.ndarray:
    """Symmetric-normalized adjacency with self loops: D^-1/2 (A+A^T+I) D^-1/2."""
    a = adj + adj.T + np.eye(adj.shape[0], dtype=np.float32)
    a = np.minimum(a, 1.0)
    d = a.sum(-1)
    dinv = 1.0 / np.sqrt(np.maximum(d, 1e-6))
    return (a * dinv[:, None]) * dinv[None, :]


# How per-app-node dynamic timing values reduce onto a (possibly merged)
# graph node: the merged node keeps its tightest slack (consistent with
# the any-member crit bit: a zero-slack member makes the merge critical)
# and the worst-case criticality / accumulated error mass of its members.
# `reduce_timing` (scalar) and `ConfigFeaturizer` (batched) follow this
# table; the err fields are log1p-compressed AFTER reduction.
DYNAMIC_REDUCE = {"slack": "min", "criticality": "max",
                  "err_mae": "max", "err_wce": "max",
                  # probe fields are graph-level (identical across
                  # members), so any reduction is the identity
                  "probe_err8": "max", "probe_err16": "max"}
_LOG1P_FIELDS = ("err_mae", "err_wce")


def reduce_timing(field: str, values: Sequence[float]) -> float:
    """Reduce one dynamic-timing field over a merged node's members."""
    v = min(values) if DYNAMIC_REDUCE[field] == "min" else max(values)
    return float(np.log1p(v)) if field in _LOG1P_FIELDS else float(v)


def node_features(graph: SimpleGraph, app: AccelDef,
                  choice: Dict[str, lib.LibEntry],
                  crit_nodes: set | None = None,
                  timing: Dict[str, Dict[str, float]] | None = None,
                  schema: FeatureSchema | None = None) -> np.ndarray:
    """(N, schema.dim) float32 rows. crit_nodes=None -> crit bit left at
    0 (stage-1 input). ``timing`` maps app node id -> the per-node fields
    of `synth.static_timing` and fills the schema's dynamic timing
    columns (the loop labeling backend); without it they stay 0 and
    `dataset.ConfigFeaturizer` fills them batched."""
    from repro_torch.accel.synth import FIXED_PPA
    schema = schema or ACTIVE_SCHEMA
    out = np.zeros((len(graph.node_ids), schema.dim), np.float32)
    us = schema.sl("unit_stats")
    kind0 = schema.start("kind_onehot")
    dyn_fields = schema.dynamic_fields
    dyn0 = schema.dynamic_slice.start
    for i, nid in enumerate(graph.node_ids):
        k = graph.kinds[i]
        if graph.fixed[i]:
            pp = FIXED_PPA[k]
            base = [pp["area"], pp["power"], pp["latency"],
                    0.0, 0.0, 0.0, 0.0, 0.0]
        else:
            e = choice[nid]
            base = [e.area, e.power, e.latency, e.mae, e.mre, e.mse, e.wce,
                    float(e.inst.level)]
        out[i, us] = base
        members = graph.merged_from[i]
        if crit_nodes is not None:
            # merged fixed nodes: critical if any member is critical
            out[i, schema.crit_index] = float(
                any(m in crit_nodes for m in members))
        if timing is not None:
            for f_idx, f in enumerate(dyn_fields):
                out[i, dyn0 + f_idx] = np.float32(reduce_timing(
                    f, [timing[m][f] for m in members]))
        out[i, kind0 + KIND_VOCAB.index(k)] = 1.0
    return out


def pad_batch(graphs: Sequence[np.ndarray], feats: Sequence[np.ndarray],
              n_pad: int, feature_dim: int = None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (adj (B,N,N) normalized, x (B,N,F), mask (B,N)).

    An empty batch returns (0, n_pad, ...) tensors (feature width from
    ``feature_dim``, defaulting to FEATURE_DIM) instead of raising."""
    B = len(graphs)
    if len(graphs) != len(feats):
        raise ValueError(f"pad_batch: {len(graphs)} graphs vs "
                         f"{len(feats)} feature blocks")
    F = feats[0].shape[-1] if feats else (feature_dim or FEATURE_DIM)
    A = np.zeros((B, n_pad, n_pad), np.float32)
    X = np.zeros((B, n_pad, F), np.float32)
    M = np.zeros((B, n_pad), np.float32)
    for b, (a, x) in enumerate(zip(graphs, feats)):
        n = a.shape[0]
        A[b, :n, :n] = normalized_adjacency(a)
        X[b, :n] = x
        M[b, :n] = 1.0
    return A, X, M
