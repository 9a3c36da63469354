"""Dataset construction for the PPA/accuracy prediction models (Sec III-B1).

Random sampling over the (pruned) design space with symmetric-structure
deduplication (NumPy ``default_rng``, so the same configs as
`repro.core.dataset`); labels from the batched synthesis oracle (PPA +
critical path, NumPy) and the config-batched functional model (SSIM, on
the requested device through the `lut_eval` kernel). Features and labels
are NumPy arrays; `ConfigFeaturizer` caches every config-independent
column.
"""
from __future__ import annotations

import threading
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import device as device_lib
from repro_torch.accel import apps as apps_lib
from repro_torch.accel import batch_oracle
from repro_torch.accel import library as lib
from repro_torch.core import graph as graph_lib
from repro_torch.data import images as images_lib

# function-level symmetric tap groups (equal coefficients / equivalent
# streams) used for duplicate elimination
SYMMETRY = {
    "gaussian": (("m0", "m2", "m6", "m8"), ("m1", "m3", "m5", "m7")),
    "sobel": (),
    "kmeans": (),
    "dct8": (),     # butterfly lanes see distinct coefficient schedules
    "fir15": (),    # every tap pair has a distinct coefficient
}


@dataclass
class AccelDataset:
    app_name: str
    graph: graph_lib.SimpleGraph
    adj: np.ndarray          # (B,N,N) normalized
    x: np.ndarray            # (B,N,F) crit bit zeroed
    mask: np.ndarray         # (B,N)
    unit_mask: np.ndarray    # (B,N) 1 on arithmetic-unit nodes
    y: np.ndarray            # (B,4) normalized [area,power,latency,ssim]
    y_raw: np.ndarray
    crit: np.ndarray         # (B,N) ground truth critical-path bits
    configs: List[Tuple[int, ...]]
    y_mean: np.ndarray
    y_std: np.ndarray
    x_mean: np.ndarray
    x_std: np.ndarray
    schema_version: int = graph_lib.ACTIVE_SCHEMA.version

    @property
    def schema(self) -> graph_lib.FeatureSchema:
        return graph_lib.schema_for(self.schema_version)

    def denorm_y(self, y: np.ndarray) -> np.ndarray:
        return y * self.y_std + self.y_mean


def canonical(app: apps_lib.AccelDef, config: Dict[str, int]
              ) -> Tuple[int, ...]:
    """Sort instance indices inside each symmetric group -> canonical key."""
    cfg = dict(config)
    for group in SYMMETRY.get(app.name, ()):
        vals = sorted(cfg[g] for g in group)
        for g, v in zip(group, vals):
            cfg[g] = v
    return tuple(cfg[n.id] for n in app.unit_nodes)


def sample_configs(app: apps_lib.AccelDef, n: int, seed: int = 0,
                   lib_entries: Optional[Dict[str, Sequence]] = None,
                   dedup: bool = True) -> List[Tuple[int, ...]]:
    """Random (deduplicated) configuration sample over the design space.

    May return FEWER than ``n`` configs: with ``dedup=True`` rejection
    sampling is capped at 50·n tries, and the shortfall is reported with
    `warnings.warn`.
    """
    rng = np.random.default_rng(seed)
    entries = lib_entries or {k.kind: lib.build_library(k.kind)
                              for k in app.unit_nodes}
    sizes = [len(entries[k.kind]) for k in app.unit_nodes]
    seen = set()
    out: List[Tuple[int, ...]] = []
    tries = 0
    while len(out) < n and tries < 50 * n:
        tries += 1
        cfg = {node.id: int(rng.integers(0, s))
               for node, s in zip(app.unit_nodes, sizes)}
        key = canonical(app, cfg) if dedup else tuple(
            cfg[node.id] for node in app.unit_nodes)
        if dedup and key in seen:
            continue
        seen.add(key)
        out.append(key)
    if len(out) < n:
        warnings.warn(
            f"sample_configs({app.name!r}): dedup retry cap (50*n="
            f"{50 * n} tries) reached with {len(out)}/{n} unique configs "
            f"— the (canonicalized) design space is likely smaller than "
            f"n; proceeding with {len(out)} samples", stacklevel=2)
    return out


class ConfigFeaturizer:
    """Config -> node-feature tensors with cached constant columns.

    Every configuration of one accelerator shares the graph topology, so
    the normalized adjacency, mask, fixed-node rows, one-hot kind columns
    and padding are constants; only the unit-stats block of the
    arithmetic-unit rows depends on the chosen library entry, the
    critical-path column on the oracle, and — under schema v2 — the
    dynamic timing block on the batched timing oracle and the functional
    probe (which runs on ``device``).

    `raw` feeds `build` (labels known, stats not yet); `normalized` feeds
    the surrogate engine. Both cast the float64 timing sweep to float32
    once and standardize elementwise, so their rows are bit-identical.
    """

    def __init__(self, g: graph_lib.SimpleGraph, app: apps_lib.AccelDef,
                 entries: Dict[str, Sequence], n_pad: int,
                 schema: Optional[graph_lib.FeatureSchema] = None,
                 device=None):
        self.schema = schema or graph_lib.ACTIVE_SCHEMA
        self.device = device_lib.resolve(device)
        self.n_pad = n_pad
        self.n_nodes = len(g.node_ids)
        self.sizes = [len(entries[n.kind]) for n in app.unit_nodes]
        self._graph = g
        self._app = app
        self._entries = entries
        self.dynamic = bool(self.schema.dynamic_fields)
        self._members: Optional[List[np.ndarray]] = None
        # `normalized` runs on the engine's featurize worker thread while
        # other callers may share this featurizer; the lock makes the lazy
        # member-index build single-shot
        self._members_lock = threading.Lock()
        choice0 = {n.id: entries[n.kind][0] for n in app.unit_nodes}
        xf0 = graph_lib.node_features(g, app, choice0, crit_nodes=None,
                                      schema=self.schema)
        A, X0, M = graph_lib.pad_batch([g.adj], [xf0], n_pad)
        self.adj = A[0]                           # (N, N) normalized
        self.mask = M[0]                          # (N,)
        self.base_raw = X0[0]                     # (N, F), unit rows dummy
        self.gidx = [g.node_ids.index(n.id) for n in app.unit_nodes]
        self._us = self.schema.sl("unit_stats")
        kind_tables: Dict[str, np.ndarray] = {}
        self.tables_raw: List[np.ndarray] = []
        for node in app.unit_nodes:
            if node.kind not in kind_tables:
                kind_tables[node.kind] = np.asarray(
                    [[e.area, e.power, e.latency, e.mae, e.mre, e.mse,
                      e.wce, float(e.inst.level)]
                     for e in entries[node.kind]], np.float32)
            self.tables_raw.append(kind_tables[node.kind])
        self._norm = None

    # -- dynamic timing block ----------------------------------------------

    def _member_index(self) -> List[np.ndarray]:
        """Per graph node: app-node positions of its merged members in the
        compiled DAG's node order."""
        with self._members_lock:
            if self._members is None:
                ca = batch_oracle.compile_app(self._app.name)
                pos = {nid: a for a, nid in enumerate(ca.node_ids)}
                members = [
                    np.asarray([pos[m] for m in self._graph.merged_from[i]],
                               np.int64) for i in range(self.n_nodes)]
                # singleton fast path: one gather covers every unmerged
                # node; only merged fixed nodes need a per-node reduction
                self._first = np.asarray([m[0] for m in members], np.int64)
                self._multi = [i for i, m in enumerate(members)
                               if len(m) > 1]
                self._members = members
            return self._members

    def dynamic_raw(self, C: np.ndarray) -> np.ndarray:
        """(B, n_graph_nodes, n_dyn) float32 dynamic timing features: one
        `batch_oracle.timing_batch` sweep plus the functional probe,
        reduced onto the (possibly merged) graph nodes per
        `graph.DYNAMIC_REDUCE` and log1p-compressed where the schema says
        so."""
        fields = self.schema.dynamic_fields
        rep = batch_oracle.timing_batch(self._app, self._entries, C)
        if any(f in apps_lib.PROBE_FIELDS for f in fields):
            rep.update(batch_oracle.probe_batch(
                self._app, self._entries, C, device=self.device))
        members = self._member_index()
        out = np.empty((C.shape[0], self.n_nodes, len(fields)), np.float32)
        for f_idx, f in enumerate(fields):
            if f in apps_lib.PROBE_FIELDS:
                # graph-level probe distortion, broadcast across nodes
                out[:, :, f_idx] = rep[f][:, None]
                continue
            col = rep[f]                             # (B, n_app_nodes)
            take_min = graph_lib.DYNAMIC_REDUCE[f] == "min"
            v = col[:, self._first]                  # (B, n_graph_nodes)
            for i in self._multi:
                mem = members[i]
                v[:, i] = (col[:, mem].min(1) if take_min
                           else col[:, mem].max(1))
            if f in graph_lib._LOG1P_FIELDS:
                v = np.log1p(v)
            out[:, :, f_idx] = v
        return out

    # -- feature assembly --------------------------------------------------

    def raw(self, configs, crit: Optional[np.ndarray] = None) -> np.ndarray:
        """(B, n_pad, F) un-normalized features; ``crit`` is an optional
        (B, n_graph_nodes) critical-bit block from the batch oracle."""
        C = np.asarray(configs, np.int64).reshape(-1, len(self.gidx))
        X = np.broadcast_to(self.base_raw,
                            (C.shape[0],) + self.base_raw.shape).copy()
        for j, gj in enumerate(self.gidx):
            X[:, gj, self._us] = self.tables_raw[j][C[:, j]]
        if self.dynamic:
            X[:, :self.n_nodes, self.schema.dynamic_slice] = \
                self.dynamic_raw(C)
        if crit is not None:
            X[:, :self.n_nodes, self.schema.crit_index] = crit
        return X

    def set_norm(self, x_mean: np.ndarray, x_std: np.ndarray) -> None:
        base = ((self.base_raw - x_mean) / x_std
                * self.mask[..., None]).astype(np.float32)
        mu8 = x_mean[self._us].astype(np.float32)
        sd8 = x_std[self._us].astype(np.float32)
        tables = [((t - mu8) / sd8).astype(np.float32)
                  for t in self.tables_raw]
        dyn = self.schema.dynamic_slice
        mu_d = np.asarray(x_mean[dyn], np.float32)
        sd_d = np.asarray(x_std[dyn], np.float32)
        self._norm = (base, tables, mu_d, sd_d)

    def normalized(self, configs) -> np.ndarray:
        """(B, n_pad, F) features normalized with the dataset stats."""
        if self._norm is None:
            raise RuntimeError("call set_norm(x_mean, x_std) first")
        base, tables, mu_d, sd_d = self._norm
        C = np.asarray(configs, np.int64).reshape(-1, len(self.gidx))
        X = np.broadcast_to(base, (C.shape[0],) + base.shape).copy()
        for j, gj in enumerate(self.gidx):
            X[:, gj, self._us] = tables[j][C[:, j]]
        if self.dynamic:
            # same float32 cast + elementwise standardization the build
            # path applies to the whole raw tensor -> bit-identical rows
            X[:, :self.n_nodes, self.schema.dynamic_slice] = \
                (self.dynamic_raw(C) - mu_d) / sd_d
        return X


def _entries_sig(entries: Dict[str, Sequence]) -> Tuple:
    return tuple(sorted((k, tuple(e.inst.name for e in v))
                        for k, v in entries.items()))


def build(app_name: str, n_samples: int = 2000, seed: int = 0,
          n_images: int = 4, img_size: int = 64,
          lib_entries: Optional[Dict[str, Sequence]] = None,
          simplify_graph: bool = True, n_pad: int = 32,
          label_chunk: int = 256, device=None) -> AccelDataset:
    """Sample ``n_samples`` configurations and label them: synthesis PPA
    and critical bits on the host, SSIM through the config-batched
    functional model on ``device`` (default: the CUDA card)."""
    dev = device_lib.resolve(device)
    app = apps_lib.APPS[app_name]
    g = graph_lib.build_graph(app, simplify=simplify_graph)
    entries = lib_entries or {k: lib.build_library(k) for k in
                              {n.kind for n in app.unit_nodes}}

    inp = apps_lib.app_inputs(app_name, images_lib.image_set(n_images,
                                                             img_size), dev)
    exact_out = app.run(apps_lib.make_impls(app, apps_lib.exact_choice(app)),
                        inp)

    configs = sample_configs(app, n_samples, seed, lib_entries=entries)
    C = np.asarray(configs, np.int64)
    rep = batch_oracle.synthesize_batch(app, entries, C)
    acc = apps_lib.accuracy_ssim_batch(app, entries, C, inp, exact_out,
                                       chunk=label_chunk)
    y_raw = np.stack([rep["area"], rep["power"], rep["latency"], acc],
                     axis=1).astype(np.float32)
    # map app-node critical bits onto the (possibly merged) graph nodes
    pos = {nid: a for a, nid in enumerate(rep["node_ids"])}
    memb = np.zeros((len(g.node_ids), len(rep["node_ids"])), np.float32)
    for i, members in enumerate(g.merged_from):
        for m in members:
            memb[i, pos[m]] = 1.0
    crit_graph = (rep["crit"].astype(np.float32)
                  @ memb.T > 0).astype(np.float32)
    feat = ConfigFeaturizer(g, app, entries, n_pad, device=dev)
    X = feat.raw(C, crit=crit_graph)
    A = np.broadcast_to(feat.adj, (len(configs),) + feat.adj.shape).copy()
    M = np.broadcast_to(feat.mask, (len(configs),) + feat.mask.shape).copy()

    schema = graph_lib.ACTIVE_SCHEMA
    crit = X[..., schema.crit_index].copy()
    X[..., schema.crit_index] = 0.0
    unit_mask = np.zeros_like(M)
    unit_ids = {n.id for n in app.unit_nodes}
    for j, nid in enumerate(g.node_ids):
        if nid in unit_ids:
            unit_mask[:, j] = 1.0
    # normalize
    y_mean, y_std = y_raw.mean(0), y_raw.std(0) + 1e-6
    y = (y_raw - y_mean) / y_std
    x_mean = X.reshape(-1, X.shape[-1]).mean(0)
    x_std = X.reshape(-1, X.shape[-1]).std(0) + 1e-6
    # one-hot / crit-bit columns stay raw; the schema says which
    keep = schema.normalize_mask()
    x_mean[~keep] = 0.0
    x_std[~keep] = 1.0
    Xn = (X - x_mean) / x_std * M[..., None]
    return AccelDataset(app_name, g, A, Xn, M, unit_mask, y, y_raw, crit,
                        configs, y_mean, y_std, x_mean, x_std,
                        schema_version=schema.version)


_featurizer_lock = threading.Lock()


def featurizer_for(ds: AccelDataset, app: apps_lib.AccelDef,
                   entries: Dict[str, Sequence], device=None
                   ) -> ConfigFeaturizer:
    """Get-or-build the dataset's normalized featurizer, cached on ``ds``
    per (library signature, device)."""
    dev = device_lib.resolve(device)
    key = (_entries_sig(entries), str(dev))
    with _featurizer_lock:
        cache = ds.__dict__.setdefault("_featurizers", {})
        feat = cache.get(key)
        if feat is None:
            feat = ConfigFeaturizer(ds.graph, app, entries, ds.x.shape[1],
                                    schema=ds.schema, device=dev)
            feat.set_norm(ds.x_mean, ds.x_std)
            cache[key] = feat
    return feat


def features_for_configs(ds: AccelDataset, app: apps_lib.AccelDef,
                         entries: Dict[str, Sequence],
                         configs: Sequence[Tuple[int, ...]], device=None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Surrogate-input tensors (adj, x, mask) for arbitrary configs."""
    feat = featurizer_for(ds, app, entries, device)
    Xn = feat.normalized(configs)
    B = Xn.shape[0]
    A = np.broadcast_to(feat.adj, (B,) + feat.adj.shape).copy()
    M = np.broadcast_to(feat.mask, (B,) + feat.mask.shape).copy()
    return A, Xn, M
