"""Dataset construction for the PPA/accuracy prediction models (Sec III-B1).

Random sampling over the (pruned) design space with symmetric-structure
deduplication (NumPy ``default_rng``, so the same configs as
`repro.core.dataset`); labels from the batched synthesis oracle (PPA +
critical path, NumPy) and the config-batched functional model (SSIM, on
the requested device through the `lut_eval` kernel), or from the scalar
reference path (``label_backend="loop"``). Features and labels are NumPy
arrays; `ConfigFeaturizer` caches every config-independent column.
`merge` joins per-app datasets into the cross-app `MergedDataset`.
"""
from __future__ import annotations

import dataclasses
import threading
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import device as device_lib
from repro_torch.accel import apps as apps_lib
from repro_torch.accel import batch_oracle
from repro_torch.accel import library as lib
from repro_torch.accel import synth
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

    # Every config of one accelerator shares the graph topology, so adj,
    # mask and unit_mask are B identical rows: a pickle keeps one row and
    # the count. The featurizer cache (`featurizer_for`) is keyed by a
    # device and rebuilt on demand, so a pickle never carries it.
    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_featurizers", None)
        for k in ("adj", "mask", "unit_mask"):
            v = state[k]
            if isinstance(v, np.ndarray) and v.shape[0] > 1 and \
                    (v == v[:1]).all():
                state[k] = ("__const_rows__", np.ascontiguousarray(v[0]),
                            v.shape[0])
        return state

    def __setstate__(self, state):
        for k, v in state.items():
            if isinstance(v, tuple) and len(v) == 3 and \
                    v[0] == "__const_rows__":
                state[k] = np.broadcast_to(
                    v[1], (v[2],) + v[1].shape).copy()
        self.__dict__.update(state)

    def split(self, frac: float = 0.9):
        """(first ``frac`` of the rows, the rest)."""
        n = int(len(self.y) * frac)

        def take(sel):
            return dataclasses.replace(
                self, adj=self.adj[sel], x=self.x[sel], mask=self.mask[sel],
                unit_mask=self.unit_mask[sel], y=self.y[sel],
                y_raw=self.y_raw[sel], crit=self.crit[sel],
                configs=self.configs[sel])
        return take(slice(None, n)), take(slice(n, None))

    def denorm_y(self, y: np.ndarray) -> np.ndarray:
        return y * self.y_std + self.y_mean

    def flat_features(self) -> np.ndarray:
        """Flat per-graph vector of the masked unit-stats block: the
        random-forest baseline's input."""
        B = self.x.shape[0]
        us = self.schema.sl("unit_stats")
        return (self.x[..., us] * self.mask[..., None]).reshape(B, -1)


@dataclass
class MergedDataset:
    """Union of per-app datasets on a common pad width, for the cross-app
    unified surrogate.

    Feature rows are each app's own-normalized features with the one-hot
    app block of `graph.APP_VOCAB` appended, so the feature dim is
    ``graph.MERGED_FEATURE_DIM`` for any app subset. Targets stay
    normalized per app (`denorm_rows` and the engine's per-app views use
    each app's y stats). Rows are shuffled at merge time, so `split`
    gives app-mixed train and test sets; `app_ids` records provenance.
    """
    app_names: Tuple[str, ...]
    adj: np.ndarray          # (B,N,N) normalized, N = common n_pad
    x: np.ndarray            # (B,N,MERGED_FEATURE_DIM) crit bit zeroed
    mask: np.ndarray         # (B,N)
    unit_mask: np.ndarray    # (B,N)
    y: np.ndarray            # (B,4) per-app normalized
    y_raw: np.ndarray        # (B,4)
    crit: np.ndarray         # (B,N)
    app_ids: np.ndarray      # (B,) index into app_names
    configs: List[Tuple[int, ...]]
    per_app: Dict[str, AccelDataset]

    _ROW_FIELDS = ("adj", "x", "mask", "unit_mask", "y", "y_raw", "crit",
                   "app_ids")

    def _take(self, sel) -> "MergedDataset":
        """Rows by slice or boolean mask: the one place the per-row fields
        are listed."""
        kw = {k: getattr(self, k)[sel] for k in self._ROW_FIELDS}
        if isinstance(sel, slice):
            kw["configs"] = self.configs[sel]
        else:
            kw["configs"] = [c for c, keep in zip(self.configs, sel) if keep]
        return dataclasses.replace(self, **kw)

    def split(self, frac: float = 0.9):
        n = int(len(self.y) * frac)
        return self._take(slice(None, n)), self._take(slice(n, None))

    def view(self, app_name: str) -> "MergedDataset":
        """The rows of one app."""
        return self._take(self.app_ids == self.app_names.index(app_name))

    def denorm_rows(self, y: np.ndarray,
                    app_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Denormalize each row with its own app's y stats."""
        ids = self.app_ids if app_ids is None else app_ids
        mean = np.stack([self.per_app[a].y_mean for a in self.app_names])
        std = np.stack([self.per_app[a].y_std for a in self.app_names])
        return y * std[ids] + mean[ids]

    @property
    def n_pad(self) -> int:
        return self.x.shape[1]


def _pad_nodes(a: np.ndarray, n_pad: int, is_adj: bool = False
               ) -> np.ndarray:
    """Zero-pad the node axis (axis 1, and axis 2 when ``is_adj``) to
    n_pad. The adjacency is flagged, not sniffed from the shape: a
    (B, N, F) feature tensor may have N == F."""
    n = a.shape[1]
    if n == n_pad:
        return a
    if n > n_pad:
        raise ValueError(f"cannot pad {n} nodes down to {n_pad}")
    widths = [(0, 0), (0, n_pad - n)] + [(0, 0)] * (a.ndim - 2)
    if is_adj:
        widths[2] = (0, n_pad - n)
    return np.pad(a, widths)


def merge(datasets: Dict[str, AccelDataset], n_pad: Optional[int] = None,
          shuffle_seed: int = 0) -> MergedDataset:
    """Merge per-app datasets (any subset of `graph.APP_VOCAB`, one app
    included) into one cross-app training set. All must share one feature
    schema; node counts may differ and are padded to ``n_pad`` (default:
    the widest input). The row order is ``default_rng(shuffle_seed)``'s
    permutation, as in `repro.core.dataset.merge`."""
    if not datasets:
        raise ValueError("merge() needs at least one dataset")
    names = tuple(sorted(datasets, key=graph_lib.APP_VOCAB.index))
    versions = {datasets[a].schema_version for a in names}
    if len(versions) != 1:
        raise ValueError(f"merge() needs one feature-schema version, got "
                         f"{sorted(versions)}: rebuild the stale datasets")
    schema = graph_lib.schema_for(versions.pop())
    dims = {datasets[a].x.shape[-1] for a in names}
    if dims != {schema.dim}:
        raise ValueError(f"merge() expects base feature dim {schema.dim} "
                         f"(schema v{schema.version}), got {sorted(dims)}")
    n_pad = n_pad or max(datasets[a].x.shape[1] for a in names)
    parts = {k: [] for k in MergedDataset._ROW_FIELDS}
    cfgs: List[Tuple[int, ...]] = []
    for i, a in enumerate(names):
        ds = datasets[a]
        m = _pad_nodes(ds.mask, n_pad)
        parts["adj"].append(_pad_nodes(ds.adj, n_pad, is_adj=True))
        parts["x"].append(graph_lib.with_app_block(_pad_nodes(ds.x, n_pad),
                                                   m, a))
        parts["mask"].append(m)
        parts["unit_mask"].append(_pad_nodes(ds.unit_mask, n_pad))
        parts["y"].append(ds.y)
        parts["y_raw"].append(ds.y_raw)
        parts["crit"].append(_pad_nodes(ds.crit, n_pad))
        parts["app_ids"].append(np.full(len(ds.y), i, np.int64))
        cfgs.extend(ds.configs)
    perm = np.random.default_rng(shuffle_seed).permutation(len(cfgs))
    rows = {k: np.concatenate(v, 0)[perm] for k, v in parts.items()}
    return MergedDataset(names, configs=[cfgs[j] for j in perm],
                         per_app={a: datasets[a] for a in names}, **rows)


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
          label_backend: str = "batched", label_chunk: int = 256,
          device=None) -> AccelDataset:
    """Sample ``n_samples`` configurations and label them on ``device``
    (default: the CUDA card).

    ``label_backend="batched"`` labels the whole block at once: synthesis
    PPA and critical bits in NumPy, SSIM through the config-batched
    functional model (`lut_eval`). ``"loop"`` is the scalar reference: one
    `synth.synthesize`, `apps.accuracy_ssim` and `synth.static_timing`
    call per configuration, then `graph.pad_batch`."""
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
    if label_backend == "batched":
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
        M = np.broadcast_to(feat.mask,
                            (len(configs),) + feat.mask.shape).copy()
    elif label_backend == "loop":
        schema = graph_lib.ACTIVE_SCHEMA
        feats, ys = [], []
        for cfg in configs:
            choice = {node.id: entries[node.kind][i]
                      for node, i in zip(app.unit_nodes, cfg)}
            rep = synth.synthesize(app, choice)
            acc = apps_lib.accuracy_ssim(app, choice, inp, exact_out)
            timing = (synth.static_timing(app, choice, dev)["nodes"]
                      if schema.dynamic_fields else None)
            feats.append(graph_lib.node_features(
                g, app, choice, crit_nodes=rep["critical_nodes"],
                timing=timing, schema=schema))
            ys.append([rep["area"], rep["power"], rep["latency"], acc])
        A, X, M = graph_lib.pad_batch([g.adj] * len(feats), feats, n_pad)
        y_raw = np.asarray(ys, np.float32)
    else:
        raise ValueError(f"label_backend must be 'batched' or 'loop', "
                         f"got {label_backend!r}")

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
