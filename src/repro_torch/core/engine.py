"""Batched surrogate-evaluation engine for the DSE hot loop.

``SurrogateEngine`` is the ``evaluate(configs) -> (n, n_obj)`` callable
that the search drives, as in `repro.core.engine`:

* **chunked inference** — batches are split into chunks of
  ``chunk_size``; with ``fixed_shape`` a ragged final chunk is padded up
  to the next power-of-two bucket, so the backend sees at most
  ``log2(chunk_size)+1`` shapes (the reference's XLA compiles one program
  per shape; the port compiles none, and its GNN engines run a ragged
  chunk as it is);
* **featurize/compute overlap** — the GNN backend is a `PipelinedBackend`
  (prepare → dispatch → collect): with ≥ 2 chunks a worker thread
  featurizes chunk *k+1* on the host (timing sweep + functional probe)
  while chunk *k* runs on the card; CUDA launches return at once, and the
  blocking device→host copies wait until every chunk is in flight;
* **config-key memoization** with keys prefixed by the feature-schema
  version, and duplicates inside one batch evaluated once;
* **cross-request batching** — `submit` enqueues a query, `drain` fuses
  every pending query into one engine call; the GNN engines run their
  readouts at the chunk's row count, so a config's row does not depend
  on the wave it is served in;
* **fault handling** — an optional retry policy around every backend call
  and a NaN guard that re-evaluates non-finite rows and quarantines
  configs whose rows stay non-finite (served as +inf).

On the card, the GNN engines (`from_gnn`, and `from_gnn_shared`, the
per-app view of the cross-app surrogate) run every message-passing layer
of the gcn and gsae architectures through the CUDA `gnn_mp` kernel; there
is no fallback to another path. `from_gnn_ensemble` serves an ensemble's
mean with its std as an uncertainty block, each member as `from_gnn`.
`from_rforest` serves the random-forest baseline and `from_oracle` the
ground truth.

Devices. The GNN engines take ``devices=``: the reference's count (``1``
no split, ``0`` every local device of ``device``'s type, ``N`` at most N
of them) or an explicit sequence of devices, which may name one device
several times. ``dispatch`` splits each featurized chunk's config rows
over the largest prefix of those devices that divides the chunk
(`distributed.meshes.shard_leading_axis`), launches the model on every
slice, and returns; ``collect`` gathers the slices in order. Every slice
runs the readouts (and mpnn its whole model) at the chunk size's rows, so
a config's row is the same at any split, bit for bit.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue as queue_lib
import threading
import time
import warnings
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import device as device_lib
from repro_torch.device import DevicesLike

Config = Tuple[int, ...]
BatchFn = Callable[[Sequence[Config]], np.ndarray]

# fraction of a call's backend rows that may be ragged padding before the
# engine warns (once per engine)
PADDING_WARN_FRACTION = 0.25


# --------------------------------------------------------------------------
# stats
# --------------------------------------------------------------------------

@dataclass
class EngineStats:
    """Counters accumulated across engine calls. Thread-safe: every
    mutation goes through `update`/`bump_max` under one lock.

    calls/configs/cache_hits/evaluated/padded/chunks/max_batch count
    requests and backend work; submits/drains the cross-request queue;
    retries and quarantined the fault handling; eval_time_s/wall_time_s
    the time in the backend and in the engine; featurize_s/dispatch_s/
    collect_s/overlapped_s the pipelined backend's phases (overlapped_s is
    featurization hidden behind device work); devices the device count
    the backend serves (kept across `SurrogateEngine.reset_stats`).
    """
    calls: int = 0
    configs: int = 0
    cache_hits: int = 0
    evaluated: int = 0
    padded: int = 0
    chunks: int = 0
    max_batch: int = 0
    submits: int = 0
    drains: int = 0
    retries: int = 0
    quarantined: int = 0
    eval_time_s: float = 0.0
    wall_time_s: float = 0.0
    devices: int = 1
    featurize_s: float = 0.0
    dispatch_s: float = 0.0
    collect_s: float = 0.0
    overlapped_s: float = 0.0

    def __post_init__(self):
        self._lock = threading.Lock()

    def update(self, **deltas) -> None:
        """Atomically add `deltas` to the named counters."""
        with self._lock:
            for name, d in deltas.items():
                setattr(self, name, getattr(self, name) + d)

    def bump_max(self, **candidates) -> None:
        """Atomically raise the named high-water-mark counters."""
        with self._lock:
            for name, v in candidates.items():
                if v > getattr(self, name):
                    setattr(self, name, v)

    @property
    def cache_hit_rate(self) -> float:
        return self.cache_hits / self.configs if self.configs else 0.0

    @property
    def configs_per_sec(self) -> float:
        return self.configs / self.wall_time_s if self.wall_time_s else 0.0

    @property
    def batch_occupancy(self) -> float:
        """Mean submissions coalesced per drain wave."""
        return self.submits / self.drains if self.drains else 0.0

    @property
    def padded_fraction(self) -> float:
        """Share of backend rows that were ragged-chunk padding."""
        total = self.evaluated + self.padded
        return self.padded / total if total else 0.0

    @property
    def overlap_fraction(self) -> float:
        """Share of host featurization hidden behind device work."""
        return self.overlapped_s / self.featurize_s \
            if self.featurize_s else 0.0

    def as_dict(self) -> Dict[str, float]:
        """A snapshot of every counter (seconds rounded to 0.1 ms) and the
        derived rates, with the keys of `repro.core.engine.EngineStats`."""
        with self._lock:
            snap = EngineStats(**{f.name: getattr(self, f.name)
                                  for f in dataclasses.fields(self)})
        out = {f.name: getattr(snap, f.name) for f in dataclasses.fields(snap)}
        out = {k: round(v, 4) if isinstance(v, float) else v
               for k, v in out.items()}
        out.update(cache_hit_rate=round(snap.cache_hit_rate, 4),
                   configs_per_sec=round(snap.configs_per_sec, 1),
                   batch_occupancy=round(snap.batch_occupancy, 3),
                   padded_fraction=round(snap.padded_fraction, 4),
                   overlap_fraction=round(snap.overlap_fraction, 4))
        return out


# --------------------------------------------------------------------------
# pipelined backends: prepare (host) -> dispatch (device) -> collect (host)
# --------------------------------------------------------------------------

class PipelinedBackend:
    """A batch backend split into its host and device phases.

    ``collect(dispatch(prepare(configs)))`` is the plain batch-function
    contract; the split lets `SurrogateEngine` overlap the phases across
    chunks: ``prepare`` featurizes on the host (worker thread),
    ``dispatch`` copies to the device and launches the model without
    waiting, ``collect`` waits for the result and post-processes it.

    ``devices`` is the split's cap, which `EngineStats` reports: a chunk
    is split over the largest prefix of the devices that divides its
    length (`distributed.meshes.shard_leading_axis`).
    """

    def __init__(self, prepare: Callable[[Sequence[Config]], Any],
                 dispatch: Callable[[Any], Any],
                 collect: Callable[[Any], np.ndarray], *,
                 devices: int = 1):
        self.prepare = prepare
        self.dispatch = dispatch
        self.collect = collect
        self.devices = max(1, int(devices))

    def __call__(self, configs: Sequence[Config]) -> np.ndarray:
        return self.collect(self.dispatch(self.prepare(configs)))


# --------------------------------------------------------------------------
# GNN predict functions
# --------------------------------------------------------------------------

# architectures whose layers' rows change with the batch's size on the card
# (cuBLAS's algorithm for their products; scripts/readout_rows.py): their
# engines run the whole model at the chunk's rows, not the readouts only
WHOLE_MODEL_AT_ROWS = frozenset({"mpnn"})


def _make_predict(two_cfg, params, adj_row: np.ndarray,
                  mask_row: np.ndarray, device: torch.device,
                  rows: int = 0):
    """X (B,N,F) on ``device`` -> normalized (B, 4) targets.

    gcn and gsae run each message-passing layer through
    `kernels.ops.gnn_mp` — the CUDA kernel on the card — whose fused
    update ``relu(A' @ (H @ Wn) + H @ Ws + b)`` is the layer with
    ``A' = adj`` (gcn) or ``A' = adj / deg`` (GraphSAGE-mean: row-scaling
    the adjacency commutes with the product). One (N,N) adjacency serves
    the whole batch. gat and mpnn, which have no kernel, run
    `gnn.layers`.

    The readouts run at ``rows`` rows at least (zero rows appended, cut
    off after): cuBLAS picks its algorithm by shape, and on the card the
    graph-level head's rows differ in their last bits between a batch of
    64 and one of 512. At one shape a config's row does not depend on the
    batch it came in, so a fused cross-request wave gives the rows a
    request alone would. The layers run at the batch's own rows, as
    `gnn_mp` computes each graph alone and gat's rows agree across batch
    sizes; mpnn's message products do not, so mpnn runs the whole model
    at ``rows`` rows (`WHOLE_MODEL_AT_ROWS`).
    """
    from repro_torch.core import gnn, models
    from repro_torch.kernels import ops

    mask = torch.from_numpy(mask_row).to(device)
    adj = torch.from_numpy(adj_row).to(device)

    if two_cfg.gnn.arch in ("gcn", "gsae"):
        a = np.asarray(adj_row, np.float32)
        if two_cfg.gnn.arch == "gsae":
            a = a / np.maximum(a.sum(-1, keepdims=True), 1e-6)
        adj_k = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        mask_col = mask[None, :, None]

        def stack(s, p, x):
            h = x * mask_col
            for lp in p["layers"]:
                h = ops.gnn_mp(adj_k, h, lp["w_self"], lp["w_nbr"], lp["b"])
                h = h * mask_col
            return h
    else:
        def stack(s, p, x):
            B = x.shape[0]
            return gnn.layers(s, p, adj.expand(B, *adj.shape), x,
                              mask.expand(B, *mask.shape))

    whole = two_cfg.gnn.arch in WHOLE_MODEL_AT_ROWS

    def pad(t):
        n = rows - t.shape[0]
        return torch.cat([t, t.new_zeros((n,) + t.shape[1:])]) if n > 0 else t

    def readout(s, p, h):
        hr = pad(h)
        return gnn.readout(s, p, hr, mask.expand(hr.shape[0],
                                                 *mask.shape))[:h.shape[0]]

    def predict(X):
        B = X.shape[0]
        if whole:
            X = pad(X)
        m = mask.expand(X.shape[0], *mask.shape)
        s1, s2 = two_cfg.stage1, two_cfg.stage2
        crit_logits = readout(s1, params.stage1,
                              stack(s1, params.stage1, X))[..., 0]
        x2 = models.with_crit_bit(two_cfg, X, m, crit_logits)
        return readout(s2, params.stage2, stack(s2, params.stage2, x2))[:B]

    return predict


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device=device, dtype=torch.float32).contiguous()


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

class SurrogateEngine:
    """Batched, memoized evaluator: ``engine(configs) -> (n, n_obj)``.

    Args:
        batch_fn:    ``configs -> (len(configs), n_obj)`` backend, or a
                     `PipelinedBackend` whose phases the engine overlaps.
        backend:     label for stats/reporting.
        chunk_size:  maximum configs per backend call; ``None`` sends the
                     whole miss list in one call (`queued_view`, whose
                     coalescing belongs to the drain side).
        overlap:     pipeline multi-chunk calls when the backend is a
                     `PipelinedBackend` (``None`` = exactly then).
        fixed_shape: pad a ragged final chunk up to a power-of-two bucket.
        cache:       memoize rows by config key across calls.
        max_cache:   cache entry bound; oldest entries evicted beyond it.
        retry:       an object with ``call(fn, arg, on_retry=...)`` (the
                     reference's `RetryPolicy` contract) applied around
                     every backend call; ``None`` = no retry.
        nan_guard:   re-evaluate configs whose rows are non-finite
                     (``nan_retries`` attempts each); quarantine those
                     that stay non-finite as +inf rows.
        schema_version: feature-schema version prefixed to memo keys.
        obj_cols:    when the backend returns extra columns beyond the
                     objectives (`from_gnn_ensemble` appends a
                     per-objective std), the first ``obj_cols`` are the
                     objectives ``__call__`` serves and the rest the
                     block ``uncertainty`` serves; None = all columns are
                     objectives.
    """

    def __init__(self, batch_fn: BatchFn, *, backend: str = "generic",
                 chunk_size: Optional[int] = 512, fixed_shape: bool = False,
                 overlap: Optional[bool] = None, cache: bool = True,
                 max_cache: int = 1_000_000, retry=None,
                 nan_guard: bool = True, nan_retries: int = 2,
                 schema_version: Optional[int] = None,
                 obj_cols: Optional[int] = None):
        if chunk_size is not None and chunk_size < 1:
            raise ValueError("chunk_size must be >= 1 (or None to "
                             "disable chunking)")
        if chunk_size is None and fixed_shape:
            raise ValueError("fixed_shape needs chunking: power-of-two "
                             "buckets are capped at chunk_size")
        self._batch_fn = batch_fn
        # the backend's phases, when it has them (None otherwise)
        self.pipeline = batch_fn if isinstance(batch_fn, PipelinedBackend) \
            else None
        self.overlap = (self.pipeline is not None) if overlap is None \
            else bool(overlap)
        self._warned_padding = False
        self.backend = backend
        self.schema_version = schema_version
        self.chunk_size = None if chunk_size is None else int(chunk_size)
        self.fixed_shape = fixed_shape
        self.obj_cols = obj_cols
        self.cache_enabled = cache
        self.max_cache = max_cache
        self.retry = retry
        self.nan_guard = nan_guard
        self.nan_retries = int(nan_retries)
        self.quarantined: set = set()
        self._cache: Dict[Config, np.ndarray] = {}
        self.devices = self.pipeline.devices if self.pipeline else 1
        self.stats = EngineStats(devices=self.devices)
        self._lock = threading.RLock()
        self._queue: List[Tuple[List[Config], Future]] = []
        self._queue_cv = threading.Condition()

    # -- public API --------------------------------------------------------

    def __call__(self, configs: Sequence[Config]) -> np.ndarray:
        """Evaluate a batch of configs; rows align with the input order.
        Concurrent callers are serialized on an internal lock."""
        with self._lock:
            out = self._call_locked(configs)
        return out[:, :self.obj_cols] if self.obj_cols else out

    def uncertainty(self, configs: Sequence[Config]) -> np.ndarray:
        """Per-config, per-objective uncertainty (ensemble std) rows,
        served from the same memoized rows as ``__call__``. Raises unless
        the backend produces them (`from_gnn_ensemble`)."""
        return self.predict_with_uncertainty(configs)[1]

    def predict_with_uncertainty(self, configs: Sequence[Config]
                                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(objectives (n, obj_cols), std (n, obj_cols)) in one pass."""
        if not self.obj_cols:
            raise ValueError(
                f"engine backend {self.backend!r} does not produce an "
                f"uncertainty column (build it with from_gnn_ensemble)")
        with self._lock:
            out = self._call_locked(configs)
        return out[:, :self.obj_cols], out[:, self.obj_cols:]

    def _call_locked(self, configs: Sequence[Config]) -> np.ndarray:
        t_wall = time.perf_counter()
        raw = [tuple(int(v) for v in c) for c in configs]
        sv = self.schema_version
        keys = raw if sv is None else [(sv,) + k for k in raw]
        self.stats.update(calls=1, configs=len(keys))
        self.stats.bump_max(max_batch=len(keys))
        miss: List[Config] = []       # raw configs for the backend
        miss_keys: List[Config] = []  # their (possibly prefixed) memo keys
        seen = set()
        for k, r in zip(keys, raw):
            if k not in self._cache and k not in seen:
                seen.add(k)
                miss.append(r)
                miss_keys.append(k)
        self.stats.update(cache_hits=len(keys) - len(miss))
        if miss:
            t0 = time.perf_counter()
            rows = self._eval_chunked(miss)
            self.stats.update(eval_time_s=time.perf_counter() - t0,
                              evaluated=len(miss))
            for k, r in zip(miss_keys, rows):
                self._cache[k] = r
        out = np.stack([self._cache[k] for k in keys], 0).astype(np.float64)
        if not self.cache_enabled:
            self._cache.clear()
        elif len(self._cache) > self.max_cache:
            drop = len(self._cache) - self.max_cache
            for k in list(itertools.islice(self._cache, drop)):
                del self._cache[k]
        self.stats.update(wall_time_s=time.perf_counter() - t_wall)
        return out

    def reset_stats(self) -> None:
        """Zero the counters (the cache and the device count are kept)."""
        with self._lock:
            self.stats = EngineStats(devices=self.devices)

    def clear_cache(self) -> None:
        """Drop all memoized rows."""
        with self._lock:
            self._cache.clear()

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    # -- cross-request batching queue --------------------------------------

    def submit(self, configs: Sequence[Config]) -> Future:
        """Enqueue a query; the future resolves to the rows a direct call
        would give once a `drain` wave picks it up."""
        fut: Future = Future()
        cfgs = list(configs)
        if not cfgs:
            fut.set_result(np.zeros((0, self.obj_cols or 0), np.float64))
            return fut
        with self._queue_cv:
            self._queue.append((cfgs, fut))
            self.stats.update(submits=1)
            self._queue_cv.notify_all()
        return fut

    def pending(self) -> int:
        """Number of submissions waiting for a drain wave."""
        with self._queue_cv:
            return len(self._queue)

    def drain(self, timeout: Optional[float] = None) -> int:
        """Evaluate ALL pending submissions as one fused engine call.

        Waits up to `timeout` seconds for a first submission (``None`` =
        don't wait), then runs the concatenated configs through
        ``__call__`` and resolves each future with its slice. Returns the
        number of submissions served. If the fused wave raises, each
        submission is evaluated on its own, so only the offending ones'
        futures carry the exception."""
        with self._queue_cv:
            if not self._queue and timeout is not None:
                self._queue_cv.wait(timeout)
            batch, self._queue = self._queue, []
        if not batch:
            return 0
        flat: List[Config] = [c for cfgs, _ in batch for c in cfgs]
        try:
            rows = self(flat)
        except Exception:
            for cfgs, fut in batch:
                try:
                    fut.set_result(self(cfgs))
                except Exception as e:       # delivered to the caller
                    fut.set_exception(e)
            self.stats.update(drains=1)
            return len(batch)
        self.stats.update(drains=1)
        off = 0
        for cfgs, fut in batch:
            fut.set_result(rows[off:off + len(cfgs)])
            off += len(cfgs)
        return len(batch)

    def abort_pending(self, exc: Optional[BaseException] = None) -> int:
        """Fail every queued submission (service shutdown); returns how
        many."""
        with self._queue_cv:
            batch, self._queue = self._queue, []
        exc = exc or RuntimeError("engine queue aborted")
        for _, fut in batch:
            fut.set_exception(exc)
        return len(batch)

    def queued_view(self, *, cache: bool = True,
                    timeout: Optional[float] = 120.0) -> "SurrogateEngine":
        """A per-request engine whose backend is ``submit(...).result()``
        on this shared engine: every holder of a view takes part in
        cross-request batching while keeping its own stats and memo. The
        view does no chunking or padding of its own (``chunk_size=None``),
        so one query is one submission."""
        parent = self

        def batch_fn(configs: Sequence[Config]) -> np.ndarray:
            return parent.submit(configs).result(timeout=timeout)

        return SurrogateEngine(batch_fn, backend=f"queued:{self.backend}",
                               chunk_size=None, fixed_shape=False,
                               cache=cache)

    # -- chunking ----------------------------------------------------------

    def _bucket(self, n: int) -> int:
        """Smallest power-of-two >= n, capped at chunk_size."""
        b = 1
        while b < n:
            b <<= 1
        return min(b, self.chunk_size)

    def _eval_backend(self, chunk: List[Config]) -> np.ndarray:
        """One backend call, re-issued under `self.retry` on transient
        faults (`stats.retries` counts every re-issue)."""
        if self.retry is None:
            return np.asarray(self._batch_fn(chunk))
        return np.asarray(self.retry.call(
            self._batch_fn, chunk,
            on_retry=lambda e: self.stats.update(retries=1)))

    def _guard_rows(self, part: List[Config], y: np.ndarray) -> np.ndarray:
        """Heal non-finite rows by re-evaluating the offending configs one
        by one; a config whose row stays non-finite is quarantined: its
        row becomes +inf and its key joins ``self.quarantined``."""
        bad = np.where(~np.all(np.isfinite(y), axis=1))[0]
        if not len(bad):
            return y
        y = np.array(y, copy=True)
        for j in bad:
            for _ in range(self.nan_retries):
                row = self._eval_backend([part[j]])[0]
                if np.all(np.isfinite(row)):
                    y[j] = row
                    break
            else:
                y[j] = np.inf
                self.quarantined.add(part[j])
                self.stats.update(quarantined=1)
        return y

    def _plan_chunks(self, configs: List[Config]
                     ) -> List[Tuple[int, int, List[Config]]]:
        """``(start, take, padded_chunk)`` work items (one for the whole
        list when ``chunk_size`` is None); fixed-shape padding up to the
        power-of-two bucket is applied and counted here."""
        plan: List[Tuple[int, int, List[Config]]] = []
        i, n = 0, len(configs)
        size = n if self.chunk_size is None else self.chunk_size
        while i < n:
            take = min(size, n - i)
            chunk = configs[i:i + take]
            if self.fixed_shape and take < self.chunk_size:
                b = self._bucket(take)
                self.stats.update(padded=b - take)
                chunk = chunk + [chunk[-1]] * (b - take)
            plan.append((i, take, chunk))
            i += take
        return plan

    def _warn_padding(self, plan, n_configs: int) -> None:
        """Once-per-engine warning when ragged padding exceeds
        `PADDING_WARN_FRACTION` of a wave's backend rows."""
        if self._warned_padding:
            return
        pad_rows = sum(len(c) - take for _, take, c in plan)
        total = pad_rows + n_configs
        if pad_rows and pad_rows > PADDING_WARN_FRACTION * total:
            self._warned_padding = True
            warnings.warn(
                f"engine[{self.backend}]: {pad_rows}/{total} backend rows "
                f"({pad_rows / total:.0%}) in this wave are ragged-chunk "
                f"padding — retune chunk_size or the caller's batch shape",
                RuntimeWarning, stacklevel=4)

    def _finish_chunk(self, configs, i, take, chunk, y) -> np.ndarray:
        if y.shape[0] != len(chunk):
            raise ValueError(f"backend returned {y.shape[0]} rows for "
                             f"{len(chunk)} configs")
        part = y[:take]
        if self.nan_guard and not np.all(np.isfinite(part)):
            part = self._guard_rows(configs[i:i + take], part)
        self.stats.update(chunks=1)
        return part

    def _eval_chunked(self, configs: List[Config]) -> np.ndarray:
        plan = self._plan_chunks(configs)
        self._warn_padding(plan, len(configs))
        if self.overlap and self.pipeline is not None and len(plan) >= 2:
            return self._eval_pipelined(plan, configs)
        return np.concatenate(
            [self._finish_chunk(configs, i, take, chunk,
                                self._eval_backend(chunk))
             for i, take, chunk in plan], 0)

    def _eval_pipelined(self, plan: List[Tuple[int, int, List[Config]]],
                        configs: List[Config]) -> np.ndarray:
        """Pipelined execution of the chunk plan: ONE worker thread runs
        the backend's ``prepare`` into a two-slot queue while this thread
        ``dispatch``es each chunk to the device without waiting; the
        blocking ``collect`` runs once every chunk is in flight. The same
        phase functions run once per chunk in the same order as the serial
        path, so rows are identical. A chunk whose phase raises is
        re-evaluated through `_eval_backend` (under the retry policy)."""
        pb = self.pipeline
        prepared: "queue_lib.Queue" = queue_lib.Queue(maxsize=2)

        def featurize_worker() -> None:
            for idx, (_, _, chunk) in enumerate(plan):
                t0 = time.perf_counter()
                try:
                    X = pb.prepare(chunk)
                except Exception as e:      # re-raised via the serial path
                    prepared.put((idx, e, time.perf_counter() - t0))
                    return
                prepared.put((idx, X, time.perf_counter() - t0))

        worker = threading.Thread(target=featurize_worker, daemon=True,
                                  name="engine-featurize")
        worker.start()
        inflight: List[Tuple[int, Any]] = []   # (plan index, handle|None)
        feat_s = disp_s = overlapped_s = 0.0
        for k in range(len(plan)):
            idx, X, dt = prepared.get()
            feat_s += dt
            if k > 0:
                # featurized while earlier chunks ran on the device
                overlapped_s += dt
            if isinstance(X, Exception):
                # worker died: this and later chunks take the serial call
                inflight.extend((j, None) for j in range(idx, len(plan)))
                break
            t0 = time.perf_counter()
            try:
                handle = pb.dispatch(X)
            except Exception:               # healed by the serial call
                handle = None
            disp_s += time.perf_counter() - t0
            inflight.append((idx, handle))
        worker.join()
        self.stats.update(featurize_s=feat_s, dispatch_s=disp_s,
                          overlapped_s=overlapped_s)
        rows: List[Optional[np.ndarray]] = [None] * len(plan)
        coll_s = 0.0
        for idx, handle in inflight:
            i, take, chunk = plan[idx]
            t0 = time.perf_counter()
            y = None
            if handle is not None:
                try:
                    y = np.asarray(pb.collect(handle))
                except Exception:           # healed by the serial call
                    y = None
            if y is None:
                y = self._eval_backend(chunk)
            coll_s += time.perf_counter() - t0
            rows[idx] = self._finish_chunk(configs, i, take, chunk, y)
        self.stats.update(collect_s=coll_s)
        return np.concatenate(rows, 0)

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_gnn(cls, two_cfg, params, ds, app,
                 entries: Dict[str, Sequence], *, chunk_size: int = 512,
                 cache: bool = True, devices: DevicesLike = 1,
                 overlap: Optional[bool] = None,
                 parity_atol: float = 2e-3, device=None
                 ) -> "SurrogateEngine":
        """GNN-surrogate engine (the ApproxPilot fast path) on ``device``
        (default: the CUDA card).

        Featurizes by table lookup plus the schema-v2 timing sweep and
        functional probe, runs the two-stage model on chunks of up to
        ``chunk_size`` configs, its readouts at ``chunk_size`` rows
        (`_make_predict`), denormalizes and flips ssim to the minimized
        ``1 - ssim``. For gcn/gsae every message-passing layer
        goes through `kernels.ops.gnn_mp` (the CUDA kernel on the card);
        at construction that path is held against `models.predict` on a
        small probe batch and a mismatch beyond ``parity_atol`` (on
        normalized outputs) raises, on each device of the split.

        ``devices``: split each chunk's config rows over these devices
        (module docstring); the rows equal ``devices=1``'s bit for bit.
        """
        from repro_torch.core import dataset as ds_lib

        dev = device_lib.resolve(device)
        devs = _resolve_devices(devices, dev)
        feat = ds_lib.featurizer_for(ds, app, entries, dev)
        sv = two_cfg.schema_version
        if sv != feat.schema.version:
            raise ValueError(
                f"model was trained on feature schema v{sv} but the "
                f"dataset featurizes with v{feat.schema.version} — "
                f"rebuild the stale artifact")
        pb, backend = _gnn_backend(two_cfg, params, feat, feat.normalized,
                                   ds.denorm_y, devs, parity_atol,
                                   chunk_size)
        return cls(pb, backend=backend, chunk_size=chunk_size,
                   cache=cache, overlap=overlap,
                   schema_version=sv)

    @classmethod
    def from_gnn_shared(cls, two_cfg, params, merged, app_name: str,
                        entries: Dict[str, Sequence], *,
                        chunk_size: int = 512, cache: bool = True,
                        devices: DevicesLike = 1,
                        overlap: Optional[bool] = None,
                        parity_atol: float = 2e-3, device=None
                        ) -> "SurrogateEngine":
        """Per-app view of the cross-app unified surrogate on ``device``.

        ``merged`` is the `dataset.MergedDataset` the shared ``params``
        (one two-stage model over the merged feature layout) were fitted
        on. The view featurizes with the app's own `ConfigFeaturizer` at
        the merged pad width, appends the app-identity block and
        denormalizes with the app's y stats; the model runs as in
        `from_gnn` (`gnn_mp` in every gcn/gsae layer on the card, held
        against `models.predict` at construction, ``devices`` split as
        there).
        """
        from repro_torch.accel import apps as apps_lib
        from repro_torch.core import dataset as ds_lib
        from repro_torch.core import graph as graph_lib

        if app_name not in merged.per_app:
            raise ValueError(f"{app_name!r} not in merged dataset "
                             f"{merged.app_names}")
        dev = device_lib.resolve(device)
        devs = _resolve_devices(devices, dev)
        ds = merged.per_app[app_name]
        feat = ds_lib.ConfigFeaturizer(ds.graph, apps_lib.APPS[app_name],
                                       entries, merged.n_pad,
                                       schema=ds.schema, device=dev)
        feat.set_norm(ds.x_mean, ds.x_std)
        block = graph_lib.app_block(app_name, feat.mask)      # (N, A)

        def featurize(configs):
            X = feat.normalized(configs)
            return np.concatenate(
                [X, np.broadcast_to(block, (X.shape[0],) + block.shape)],
                axis=-1)

        pb, backend = _gnn_backend(two_cfg, params, feat, featurize,
                                   ds.denorm_y, devs, parity_atol,
                                   chunk_size)
        return cls(pb, backend=f"{backend}-shared", chunk_size=chunk_size,
                   cache=cache, overlap=overlap,
                   schema_version=feat.schema.version)

    @classmethod
    def from_rforest(cls, rf_models: Dict[int, Any], ds, app,
                     entries: Dict[str, Sequence], *,
                     chunk_size: int = 4096, cache: bool = True,
                     device=None) -> "SurrogateEngine":
        """Random-forest engine (the AutoAX baseline): the per-target
        forests (`core.rforest`, NumPy on the host) on the flat masked
        unit-stats block of the dataset's featurizer, as
        `AccelDataset.flat_features` lays it out. The featurizer's probe
        runs on ``device`` (default: the CUDA card)."""
        from repro_torch.core import dataset as ds_lib

        feat = ds_lib.featurizer_for(ds, app, entries,
                                     device_lib.resolve(device))
        us = feat.schema.sl("unit_stats")

        def batch_fn(configs):
            X = feat.normalized(configs)[:, :, us].reshape(len(configs), -1)
            preds = np.stack(
                [rf_models[i].predict(X) * ds.y_std[i] + ds.y_mean[i]
                 for i in range(4)], 1)
            preds[:, 3] = 1 - preds[:, 3]
            return preds

        return cls(batch_fn, backend="rforest", chunk_size=chunk_size,
                   fixed_shape=False, cache=cache,
                   schema_version=feat.schema.version)

    @classmethod
    def from_oracle(cls, app, entries: Dict[str, Sequence], inp, exact_out,
                    *, cache: bool = True,
                    chunk_size: int = 256) -> "SurrogateEngine":
        """Synthesis-oracle engine (ground truth): batched synthesis PPA
        plus the config-batched functional model on ``inp``'s device."""
        from repro_torch.accel import batch_oracle

        def batch_fn(configs):
            return batch_oracle.objective_rows(app, entries, configs, inp,
                                               exact_out, chunk=chunk_size)

        return cls(batch_fn, backend="oracle", chunk_size=chunk_size,
                   cache=cache)

    @classmethod
    def from_gnn_ensemble(cls, ens, ds, app, entries: Dict[str, Sequence],
                          *, chunk_size: int = 512, cache: bool = True,
                          devices: DevicesLike = 1,
                          overlap: Optional[bool] = None,
                          parity_atol: float = 2e-3, device=None
                          ) -> "SurrogateEngine":
        """Ensemble-GNN engine on ``device`` (default: the CUDA card):
        objectives are the denormalized ensemble MEAN (ssim flipped to
        ``1 - ssim``), followed by a per-objective ensemble-std block
        (columns ``[obj_cols:]``, the std times ``y_std``) that
        ``uncertainty`` serves.

        ``ens`` is a `training.EnsembleParams`. Each member runs as in
        `from_gnn`: for gcn/gsae every layer goes through `gnn_mp` on the
        card, held against `models.predict` at construction; ``devices``
        splits each chunk's rows as there, every member running on every
        slice."""
        from repro_torch.core import dataset as ds_lib
        from repro_torch.core import models

        dev = device_lib.resolve(device)
        devs = _resolve_devices(devices, dev)
        feat = ds_lib.featurizer_for(ds, app, entries, dev)
        on = _per_device(devs, lambda d: _member_predicts(
            ens, feat, feat.normalized, d, parity_atol, chunk_size))
        labels = set().union(*(lab for _, lab in on.values()))
        n_members = ens.n_members

        def dispatch(X):
            with torch.no_grad():
                return [[fn(x) for fn in on[d][0]]
                        for d, x in _split_input(X, devs)]

        def collect(handles):
            Y = np.stack([torch.cat([hs[m].cpu() for hs in handles]).numpy()
                          for m in range(n_members)], 0)
            mean = ds.denorm_y(Y.mean(0))
            std = Y.std(0) * np.asarray(ds.y_std)
            mean[:, 3] = 1 - mean[:, 3]     # ssim -> 1-ssim (minimize)
            return np.concatenate([mean, std], 1)

        pb = PipelinedBackend(feat.normalized, dispatch, collect,
                              devices=len(devs))
        return cls(pb, backend="-".join(sorted(labels)) + "-ensemble",
                   chunk_size=chunk_size, cache=cache,
                   overlap=overlap, schema_version=feat.schema.version,
                   obj_cols=len(models.TARGETS))


def _resolve_devices(devices: DevicesLike, dev: torch.device
                     ) -> List[torch.device]:
    """The engine's split devices (`device.device_list`); their count
    is the cap that `EngineStats.devices` reports."""
    return device_lib.device_list(devices, dev)


def _per_device(devs: Sequence[torch.device], build: Callable
                ) -> Dict[torch.device, Any]:
    """``{device: build(device)}`` over the distinct devices of ``devs``:
    what the engines build once per device (parameters copied there,
    predicts checked there)."""
    return {d: build(d) for d in dict.fromkeys(devs)}


def _split_input(X: np.ndarray, devs: Sequence[torch.device]
                 ) -> List[Tuple[torch.device, torch.Tensor]]:
    """(device, rows) pairs of a featurized chunk, in row order: the
    config rows split over the largest prefix of ``devs`` that divides
    them (`meshes.shard_leading_axis`), or the whole chunk on ``devs[0]``.
    Host memory is pinned for a card, so every copy is issued without
    waiting."""
    Xt = torch.from_numpy(X)
    if any(d.type == "cuda" for d in devs):
        Xt = Xt.pin_memory()
    if len(devs) > 1:
        from repro_torch.distributed import meshes
        sh = meshes.shard_leading_axis(Xt, Xt.shape[0], devices=devs)
        if isinstance(sh, meshes.Sharded):
            return list(zip(sh.mesh.device_list(), sh.shards))
    return [(devs[0], Xt.to(devs[0], non_blocking=True))]


def _checked_predict(two_cfg, params, feat, featurize: Callable,
                     dev: torch.device, parity_atol: float, rows: int):
    """``(predict, backend label)`` of one two-stage model on ``dev``
    over ``feat``'s adjacency and mask, its readouts at ``rows`` rows
    (`_make_predict`). For gcn/gsae the `gnn_mp` layer path is first held
    against `models.predict` on a small probe batch and a mismatch beyond
    ``parity_atol`` (normalized outputs) raises."""
    from repro_torch.core import models

    params = models.TwoStageParams(*(_to_device(p, dev) for p in params))
    predict = _make_predict(two_cfg, params, feat.adj, feat.mask, dev, rows)
    if two_cfg.gnn.arch not in ("gcn", "gsae"):
        return predict, "torch"
    Xp = torch.from_numpy(featurize(_probe_configs(feat.sizes))).to(dev)
    B = Xp.shape[0]
    adj = torch.from_numpy(feat.adj).to(dev).expand(B, -1, -1)
    mask = torch.from_numpy(feat.mask).to(dev).expand(B, -1)
    with torch.no_grad():
        got = predict(Xp)
        want = models.predict(two_cfg, params, adj, Xp, mask)[0]
    err = float((got - want).abs().max())
    if not err <= parity_atol:
        raise RuntimeError(
            f"gnn_mp layer path disagrees with models.predict on "
            f"the probe batch: max |diff| {err} > {parity_atol}")
    return predict, ("gnn_mp" if dev.type == "cuda" else "torch")


def _member_predicts(ens, feat, featurize: Callable, dev: torch.device,
                     parity_atol: float, rows: int
                     ) -> Tuple[List[Callable], set]:
    """`_checked_predict` of every member of the ensemble ``ens`` (a
    `training.EnsembleParams`): the members' predicts, in group order,
    and the set of their backend labels."""
    predicts, labels = [], set()
    for g_cfg, stacked in ens.groups:
        for m in range(len(stacked.stage1["ro_b2"])):
            member = pytree.tree_map(lambda a, m=m: a[m], stacked)
            fn, label = _checked_predict(g_cfg, member, feat, featurize, dev,
                                         parity_atol, rows)
            predicts.append(fn)
            labels.add(label)
    return predicts, labels


def _gnn_backend(two_cfg, params, feat, featurize: Callable, denorm_y,
                 devs: Sequence[torch.device], parity_atol: float, rows: int
                 ) -> Tuple[PipelinedBackend, str]:
    """The GNN engines' pipelined backend and its label: ``featurize``
    on the host, the two-stage model on each slice's device of ``devs``
    (`_checked_predict` once per distinct device, its readouts at ``rows``
    rows), ``denorm_y`` and the ssim flip on collect."""
    on = _per_device(devs, lambda d: _checked_predict(
        two_cfg, params, feat, featurize, d, parity_atol, rows))
    backend = on[devs[0]][1]

    def dispatch(X):
        with torch.no_grad():                # launches, does not wait
            return [on[d][0](x) for d, x in _split_input(X, devs)]

    def collect(handles):
        # waits for each device
        y = torch.cat([h.cpu() for h in handles]).numpy()
        y = denorm_y(y)
        y[:, 3] = 1 - y[:, 3]               # ssim -> 1-ssim (minimize)
        return y

    return PipelinedBackend(featurize, dispatch, collect,
                            devices=len(devs)), backend


def _probe_configs(sizes: Sequence[int], n: int = 4) -> List[Config]:
    """Small deterministic config set for the construction parity check."""
    rng = np.random.default_rng(0)
    return [tuple(int(rng.integers(0, s)) for s in sizes) for _ in range(n)]
