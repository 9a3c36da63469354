"""DSE as a service: a resident evaluation and search daemon.

The port of the evaluation half of `repro.launch.serve`. `EvalService`
keeps `SurrogateEngine`s, trained parameters and an `ArtifactStore` warm
across client sessions and serves concurrent ``predict`` / ``label`` /
``dse`` requests. Its core mechanism is cross-request batching: every
in-flight request routes its surrogate queries through
`SurrogateEngine.submit`, and one batcher thread per engine `drain`s the
queue, so queries that arrive while the backend is busy coalesce into the
next evaluation. DSE requests run generation by generation
(`repro_torch.core.dse.iter_sampler`) and stream each generation's
history entry to the client while the search runs.

    PYTHONPATH=src python -m repro_torch.launch.serve --demo eval \
        --clients 8 --requests-per-client 8 [--device cpu]

Parity guarantee: a tenant warmed from the staged pipeline (`warm_start`)
shares the engine object `run_staged` memoized for that config and
device, and drains feed the union of queued configs through the
unchanged ``engine.__call__`` path, so responses are bit-identical to
one-shot `run_staged` or direct engine calls however requests interleave.

The second half is the reference's LM continuous-batching server,
`BatchServer` (``--demo lm``): a fixed decode batch of slots, prompts
admitted by stepping the shared decode step one token at a time, one
decode wave per loop, slots freed at ``max_new``. Unlike the reference's,
a step writes only the stepped slot's cache rows and admission empties
the slot's rows, so a request's tokens do not depend on the requests
served beside it or before it in its slot (for a dense model; a
mixture-of-experts layer routes every row of the batch, and the other
rows take expert capacity).

    PYTHONPATH=src python -m repro_torch.launch.serve --demo lm \
        --arch moonshot-v1-16b-a3b [--device cpu]

A tenant's engine splits each chunk's configs over the devices of its
config's ``eval_devices`` (`core.pipeline.stage_engine`), as
`run_staged`'s does; its responses equal a one-device tenant's.
"""
from __future__ import annotations

import argparse
import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

Config = Tuple[int, ...]


# ==========================================================================
# the evaluation/search service
# ==========================================================================

class ServiceOverloaded(RuntimeError):
    """Raised by `EvalService.submit` when the in-flight request count is
    at ``max_inflight`` — bounded admission control: the caller should
    back off and resubmit instead of the service buffering unboundedly."""


@dataclass
class ServeRequest:
    """One client request.

    kind:
        ``predict`` — surrogate objective rows for ``configs``;
        ``label``   — ground-truth oracle rows for ``configs`` (the
                      tenant must have an oracle: warm-started tenants
                      build one lazily, registered tenants pass one);
        ``dse``     — run ``sampler`` for ``budget`` evaluations on the
                      tenant's engine, streaming per-generation history.
    tenant:   name returned by `EvalService.register` / ``warm_start``.
    configs:  predict/label payload.
    sampler / budget / seed / dse_kwargs:
              dse payload; ``dse_kwargs`` passes sampler knobs through
              (``pop``, ``n_islands``, ``epochs``, ``migrate_k``, ...).
    deadline_s:
              per-request deadline, measured from submission. A dse
              request checks it between generations and fails with
              `TimeoutError` (its checkpoint, if any, survives for
              resume); predict/label apply the remaining budget to their
              queued-view wait. ``None`` = no deadline.
    checkpoint_every:
              dse only: checkpoint the search every N generations (epoch
              boundaries for ``islands``) into the service's shared
              `ArtifactStore` under a key derived from (tenant, sampler,
              budget, seed, dse_kwargs). Resubmitting the identical
              request — same service or a new one on the same store —
              resumes from the last checkpoint bit-identically; the
              checkpoint is evicted when the request completes.
    """
    kind: str
    tenant: str
    configs: Optional[Sequence[Config]] = None
    sampler: str = "nsga3"
    budget: int = 256
    seed: int = 0
    dse_kwargs: Dict = field(default_factory=dict)
    deadline_s: Optional[float] = None
    checkpoint_every: int = 0


@dataclass
class ServeResponse:
    """Result envelope: ``value`` is an ``(n, n_obj)`` ndarray for
    predict/label, a `repro_torch.core.dse.DSEResult` for dse."""
    rid: int
    kind: str
    tenant: str
    ok: bool
    value: object = None
    error: Optional[str] = None
    submitted_s: float = 0.0          # perf_counter timestamps
    started_s: float = 0.0
    done_s: float = 0.0

    @property
    def latency_s(self) -> float:
        """End-to-end client-observed latency (queue wait + service)."""
        return self.done_s - self.submitted_s


class _Tenant:
    """One resident evaluation context: engine + space + optional oracle."""

    def __init__(self, name: str, engine, sizes: Sequence[int],
                 oracle=None, oracle_builder: Optional[Callable] = None):
        self.name = name
        self.engine = engine
        self.sizes = list(sizes)
        self._oracle = oracle
        self._oracle_builder = oracle_builder
        self._oracle_lock = threading.Lock()

    def oracle(self):
        """The ground-truth engine, built lazily on first label request."""
        with self._oracle_lock:
            if self._oracle is None:
                if self._oracle_builder is None:
                    raise ValueError(
                        f"tenant {self.name!r} has no oracle (label "
                        f"requests need warm_start or register(oracle=))")
                self._oracle = self._oracle_builder()
            return self._oracle


class _InFlight:
    """Book-keeping for one submitted request."""

    _DONE = object()                  # stream sentinel

    def __init__(self, rid: int, req: ServeRequest):
        self.rid = rid
        self.req = req
        self.stream_q: "queue.Queue" = queue.Queue()
        self.done = threading.Event()
        self.response: Optional[ServeResponse] = None
        self.submitted_s: float = 0.0
        # the pool thread running this request, set at handler entry;
        # `result` uses it to detect a handler that died without ever
        # completing (instead of blocking forever on `done`)
        self.worker: Optional[threading.Thread] = None


class EvalService:
    """Persistent async evaluation/search daemon.

    Args:
        store:        resident `ArtifactStore` shared by every tenant
                      warm start (``None`` = a fresh memory-only store).
        coalesce:     route request queries through the engines'
                      submit/drain queues (one batcher thread per
                      engine) so concurrent requests batch together.
                      ``False`` = serial per-request handling — each
                      handler calls the engine directly; used as the
                      serial baseline.
        max_workers:  request handler threads (concurrency, not a cap on
                      admissions — see ``max_inflight``).
        drain_wait_s: how long an idle batcher blocks waiting for the
                      first submission of a wave. Purely a shutdown
                      latency / idle-spin knob — batching itself needs
                      no timing window, because whatever queues up while
                      the backend evaluates the previous wave is taken
                      wholesale by the next drain.
        max_inflight: bounded admission control: `submit` raises
                      `ServiceOverloaded` once this many requests are
                      submitted-but-unfinished, instead of buffering an
                      unbounded backlog in the pool queue. ``None`` =
                      unbounded (the pre-hardening behavior).
        retry:        `repro_torch.distributed.fault.RetryPolicy` installed on
                      every registered tenant engine/oracle that does not
                      already carry one (transient backend faults are
                      re-issued with bounded backoff, counted in the
                      engine's ``stats.retries``), and used by the label
                      path's per-config fallback. ``None`` = no retries.
        result_timeout_s:
                      default deadline for `result`/`results` calls made
                      with ``timeout=None`` — a caller never blocks
                      forever on a request whose handler died.
        checkpoint_gc_age_s:
                      every `health` call sweeps ``search_ckpt`` store
                      entries whose last write is older than this many
                      seconds (`ArtifactStore.gc_checkpoints`) — orphans
                      of crashed/abandoned checkpointed searches that
                      would otherwise accumulate in a resident store
                      forever. ``None`` disables the sweep. Keep it well
                      above the slowest tenant's checkpoint cadence.

    Results are deterministic and bit-identical to the one-shot path no
    matter how many clients are in flight: engines memoize per config
    key, drains reuse the unchanged chunked ``__call__``, and DSE
    samplers derive all randomness from the request seed.
    """

    def __init__(self, store=None, *, coalesce: bool = True,
                 max_workers: int = 8, drain_wait_s: float = 0.02,
                 max_inflight: Optional[int] = 256, retry=None,
                 result_timeout_s: float = 600.0,
                 checkpoint_gc_age_s: Optional[float] = 3600.0):
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.core.artifacts import ArtifactStore

        self.store = store if store is not None else ArtifactStore(None)
        self.coalesce = coalesce
        self.drain_wait_s = drain_wait_s
        self.max_inflight = max_inflight
        self.retry = retry
        self.result_timeout_s = result_timeout_s
        # age past which an orphaned `search_ckpt` store entry (from a
        # crashed / abandoned checkpointed search) is swept by `health()`
        # via `ArtifactStore.gc_checkpoints`; None disables the sweep.
        # Must comfortably exceed the slowest tenant's checkpoint
        # interval, or a live search's checkpoint could be collected
        # between its own refreshes.
        self.checkpoint_gc_age_s = checkpoint_gc_age_s
        self._ckpt_gc_evicted = 0
        self._n_inflight = 0
        self._tenants: Dict[str, _Tenant] = {}
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="serve-worker")
        self._requests: Dict[int, _InFlight] = {}
        self._rid = itertools.count()
        self._lock = threading.Lock()
        self._closing = threading.Event()   # rejects new submissions
        self._stop = threading.Event()      # stops the batcher threads
        # id(engine) -> (thread, per-engine stop flag); the per-engine
        # flag lets tenant replacement retire one batcher without
        # touching the others.
        self._batchers: Dict[
            int, Tuple[threading.Thread, threading.Event]] = {}

    # -- tenants -----------------------------------------------------------

    def register(self, name: str, evaluate, sizes: Sequence[int], *,
                 oracle=None, oracle_builder: Optional[Callable] = None
                 ) -> str:
        """Register a tenant from any evaluator (wrapped via
        `dse.as_engine`); returns the tenant name. Re-registering a name
        replaces it. The service's `RetryPolicy` (if any) is installed on
        the engine/oracle unless they already carry their own."""
        from repro_torch.core.dse import as_engine

        engine = as_engine(evaluate)
        ora = as_engine(oracle) if oracle is not None else None
        if self.retry is not None:
            for eng in (engine, ora):
                if eng is not None and eng.retry is None:
                    eng.retry = self.retry
        with self._lock:
            old = self._tenants.get(name)
            self._tenants[name] = _Tenant(name, engine, sizes, oracle=ora,
                                          oracle_builder=oracle_builder)
        if self.coalesce:
            self._ensure_batcher(engine)
            if ora is not None:
                self._ensure_batcher(ora)
            if old is not None:
                self._retire_batchers([old.engine, old._oracle])
        return name

    def warm_start(self, cfg, name: Optional[str] = None,
                   device=None) -> str:
        """Build (or resume from the resident store) a tenant for one
        `PipelineConfig` on ``device`` (default: the CUDA card): prune ->
        dataset -> train -> engine through the cached stages. The
        tenant's engine is the object `run_staged` memoized for the same
        config and device (the store's memory tier), so the tenant is
        served bit-identically to `run_staged`. Label requests go to an
        oracle engine on the same device, built at the first one."""
        from repro_torch import device as device_lib
        from repro_torch.core import pipeline as P

        dev = device_lib.resolve(device)
        ctx = P.stage_prune(cfg, self.store, device=dev)
        ds = P.stage_dataset(cfg, self.store, ctx, device=dev)
        art = P.stage_train(cfg, self.store, ds, device=dev)
        engine = P.stage_engine(cfg, self.store, ctx, ds, art, device=dev)
        sizes = [len(ctx.entries[n.kind]) for n in ctx.app.unit_nodes]
        name = name or (f"{cfg.app}/" + self.store.key(
            "engine", P._on(P._engine_spec(cfg), dev)))

        def build_oracle():
            from repro_torch.core.engine import SurrogateEngine
            key = self.store.key("oracle_engine", P._on(
                {"app": cfg.app, "theta": cfg.theta}, dev))
            return self.store.get_or_build(
                "oracle_engine", key,
                lambda: SurrogateEngine.from_oracle(
                    ctx.app, ctx.entries, ctx.inp, ctx.exact_out),
                memory_only=True)

        return self.register(name, engine, sizes,
                             oracle_builder=build_oracle)

    def tenants(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._tenants))

    # -- the cross-request batching loop -----------------------------------

    def _ensure_batcher(self, engine) -> None:
        key = id(engine)
        with self._lock:
            if key in self._batchers or self._stop.is_set():
                return
            stop = threading.Event()
            th = threading.Thread(target=self._batch_loop,
                                  args=(engine, stop), daemon=True,
                                  name=f"serve-batcher-{len(self._batchers)}")
            self._batchers[key] = (th, stop)
        th.start()

    def _retire_batchers(self, engines) -> None:
        """Stop and drop the batchers of `engines` that no current tenant
        references anymore (tenant replacement): without this, the old
        engine's thread would spin until service close."""
        with self._lock:
            live = set()
            for t in self._tenants.values():
                live.add(id(t.engine))
                if t._oracle is not None:
                    live.add(id(t._oracle))
            dead = [(eng, self._batchers.pop(id(eng)))
                    for eng in engines
                    if eng is not None and id(eng) not in live
                    and id(eng) in self._batchers]
        for eng, (th, stop) in dead:
            stop.set()
            th.join(timeout=10.0)
            eng.abort_pending(RuntimeError("tenant replaced"))

    def _batch_loop(self, engine, stop: threading.Event) -> None:
        """One engine's continuous batching loop: each `drain` evaluates
        EVERYTHING queued — submissions that piled up while the previous
        wave was in the backend coalesce into one fused call (the
        cross-request occupancy is ``stats.submits / stats.drains``).

        The loop must outlive any single bad request: `drain` isolates
        wave failures into the offending futures, and the extra guard
        here keeps the thread alive even if drain itself ever throws —
        a dead batcher would wedge every later request on this engine.
        """
        while not (self._stop.is_set() or stop.is_set()):
            try:
                engine.drain(timeout=self.drain_wait_s)
            except BaseException:  # noqa: BLE001 — futures carry errors
                pass
        try:
            engine.drain(timeout=None)   # serve stragglers, then fail rest
        except BaseException:            # noqa: BLE001
            pass
        engine.abort_pending(RuntimeError(
            "EvalService closed" if self._stop.is_set()
            else "tenant replaced"))

    def _eval_for(self, tenant: _Tenant, engine=None,
                  wait_s: Optional[float] = None):
        """The evaluator a request handler should use: a queued view
        participating in cross-request batching, or the engine directly
        in serial (``coalesce=False``) mode. ``wait_s`` caps how long the
        view waits on the drain side (a request deadline's remaining
        budget); None keeps the view's default."""
        engine = engine if engine is not None else tenant.engine
        if not self.coalesce:
            return engine
        return (engine.queued_view(timeout=wait_s) if wait_s is not None
                else engine.queued_view())

    # -- request lifecycle -------------------------------------------------

    def submit(self, req: ServeRequest) -> int:
        """Enqueue a request; returns a request id immediately. Raises
        (rather than failing the response) on malformed submissions:
        unknown tenant, or predict/label configs out of range for the
        tenant's space — and `ServiceOverloaded` when ``max_inflight``
        requests are already submitted-but-unfinished (admission
        control: reject loudly instead of buffering unboundedly)."""
        if self._closing.is_set():
            raise RuntimeError("EvalService is closed")
        with self._lock:
            try:
                tenant = self._tenants[req.tenant]
            except KeyError:
                raise KeyError(f"unknown tenant {req.tenant!r} "
                               f"(have {sorted(self._tenants)})") from None
        self._validate(req, tenant)
        with self._lock:
            if self.max_inflight is not None and \
                    self._n_inflight >= self.max_inflight:
                raise ServiceOverloaded(
                    f"EvalService at capacity: {self._n_inflight} "
                    f"in-flight requests (max_inflight="
                    f"{self.max_inflight}); back off and resubmit, or "
                    f"raise max_inflight")
            self._n_inflight += 1
            rid = next(self._rid)
            rec = _InFlight(rid, req)
            self._requests[rid] = rec
        rec.submitted_s = time.perf_counter()
        self._pool.submit(self._run_request, rec)
        return rid

    @staticmethod
    def _validate(req: ServeRequest, tenant: _Tenant) -> None:
        """Reject out-of-range predict/label configs at the door, before
        they can reach (and blow up inside) a fused cross-request wave."""
        if req.kind not in ("predict", "label"):
            return
        sizes = tenant.sizes
        for cfg in req.configs or ():
            if len(cfg) != len(sizes) or any(
                    not 0 <= int(v) < s for v, s in zip(cfg, sizes)):
                raise ValueError(
                    f"config {tuple(cfg)} out of range for tenant "
                    f"{tenant.name!r} (space sizes {sizes})")

    def _run_request(self, rec: _InFlight) -> None:
        rec.worker = threading.current_thread()
        req = rec.req
        t_start = time.perf_counter()
        try:
            value = self._dispatch(req, rec)
            resp = ServeResponse(rec.rid, req.kind, req.tenant, True,
                                 value=value)
        except BaseException as e:     # noqa: BLE001 — reported to client
            resp = ServeResponse(rec.rid, req.kind, req.tenant, False,
                                 error=f"{type(e).__name__}: {e}")
        finally:
            with self._lock:
                self._n_inflight -= 1
        resp.submitted_s = rec.submitted_s
        resp.started_s = t_start
        resp.done_s = time.perf_counter()
        rec.response = resp
        rec.stream_q.put(_InFlight._DONE)
        rec.done.set()

    def _deadline_at(self, rec: _InFlight) -> Optional[float]:
        """Absolute perf_counter cutoff of a request's deadline_s (from
        submission, so queue wait counts), or None."""
        if rec.req.deadline_s is None:
            return None
        return rec.submitted_s + rec.req.deadline_s

    @staticmethod
    def _remaining(deadline_at: Optional[float], what: str) -> Optional[float]:
        """Budget left until `deadline_at`; raises once it is spent."""
        if deadline_at is None:
            return None
        left = deadline_at - time.perf_counter()
        if left <= 0:
            raise TimeoutError(what)
        return left

    def _dispatch(self, req: ServeRequest, rec: _InFlight):
        with self._lock:
            tenant = self._tenants[req.tenant]
        deadline_at = self._deadline_at(rec)
        over = (f"request exceeded deadline_s={req.deadline_s} "
                f"({req.kind} on tenant {req.tenant!r})")
        if req.kind == "predict":
            wait = self._remaining(deadline_at, over)
            return np.asarray(
                self._eval_for(tenant, wait_s=wait)(list(req.configs)))
        if req.kind == "label":
            oracle = tenant.oracle()
            if self.coalesce:
                self._ensure_batcher(oracle)
            wait = self._remaining(deadline_at, over)
            ev = self._eval_for(tenant, oracle, wait_s=wait)
            cfgs = list(req.configs)
            try:
                return np.asarray(ev(cfgs))
            except BaseException:      # noqa: BLE001 — per-config fallback
                if self.retry is None:
                    raise
                # Per-config retry: a transient oracle fault poisons only
                # the batch it struck; labeling each config individually
                # under the retry policy recovers every healthy row and
                # names the persistently-failing config instead of
                # failing the whole labeling job anonymously.
                rows = []
                for c in cfgs:
                    try:
                        rows.append(np.asarray(self.retry.call(ev, [c]))[0])
                    except BaseException as e:   # noqa: BLE001 — named
                        raise RuntimeError(
                            f"label request failed persistently on config "
                            f"{tuple(int(v) for v in c)}: "
                            f"{type(e).__name__}: {e}") from e
                return np.stack(rows, 0)
        if req.kind == "dse":
            from repro_torch.core import dse as dse_lib

            kwargs = dict(req.dse_kwargs)
            ck_key = None
            if req.checkpoint_every:
                # Crash-resumable dse: checkpoints live in the service's
                # shared store under a key derived from the request
                # identity, so resubmitting the identical request — from
                # this service or a NEW one on the same store after a
                # crash — resumes from the last epoch barrier instead of
                # restarting, bit-identically.
                ck_key = self.store.key("search_ckpt", {
                    "tenant": req.tenant, "sampler": req.sampler,
                    "budget": int(req.budget), "seed": int(req.seed),
                    "kwargs": kwargs})
                try:
                    kwargs["resume_from"] = self.store.get(ck_key)
                except KeyError:
                    pass
                kwargs["checkpoint_every"] = req.checkpoint_every
                kwargs["checkpoint_sink"] = \
                    lambda ck: self.store.put(ck_key, ck)
            gen = dse_lib.iter_sampler(
                req.sampler, tenant.sizes, self._eval_for(tenant),
                req.budget, seed=req.seed, **kwargs)
            while True:
                self._remaining(deadline_at, over + (
                    "; the search checkpoint survives — resubmit the "
                    "identical request to resume" if ck_key else ""))
                try:
                    rec.stream_q.put(next(gen))
                except StopIteration as e:
                    if ck_key is not None:
                        self.store.evict(ck_key)
                    return e.value
        raise ValueError(f"unknown request kind {req.kind!r}")

    def stream(self, rid: int, timeout: Optional[float] = 300.0
               ) -> Iterator[Dict]:
        """Iterate a dse request's per-generation history entries as the
        search produces them (returns immediately-exhausted for
        predict/label). The yielded dicts are exactly the entries of the
        final ``DSEResult.history`` (same objects, same order).

        Streaming is consuming: entries already yielded are gone, so a
        second ``stream(rid)`` on a finished request returns immediately
        empty instead of blocking. A stall longer than `timeout` while
        the request is still running raises `TimeoutError`."""
        rec = self._rec(rid)
        while True:
            if rec.done.is_set():
                # Finished request: serve whatever is still queued, then
                # stop — never block on an already-consumed stream.
                try:
                    entry = rec.stream_q.get_nowait()
                except queue.Empty:
                    return
            else:
                try:
                    entry = rec.stream_q.get(timeout=timeout)
                except queue.Empty:
                    raise TimeoutError(
                        f"request {rid} produced no stream entry within "
                        f"{timeout}s") from None
            if entry is _InFlight._DONE:
                return
            yield entry

    def result(self, rid: int, timeout: Optional[float] = None
               ) -> ServeResponse:
        """Block until the request finishes; returns its response. The
        request stays retrievable until `forget(rid)`.

        Never hangs forever: ``timeout=None`` applies the service default
        ``result_timeout_s`` instead of waiting unboundedly, and a
        handler thread that died without completing (a killed worker, an
        interpreter-level fault) raises immediately with the dead
        handler's name rather than blocking out the full deadline."""
        rec = self._rec(rid)
        budget = self.result_timeout_s if timeout is None else timeout
        t_end = time.monotonic() + budget
        while True:
            left = t_end - time.monotonic()
            if rec.done.wait(timeout=max(0.0, min(0.05, left))):
                return rec.response
            worker = rec.worker
            if worker is not None and not worker.is_alive():
                raise RuntimeError(
                    f"request {rid} ({rec.req.kind} on tenant "
                    f"{rec.req.tenant!r}) can never complete: handler "
                    f"thread {worker.name!r} died without producing a "
                    f"response")
            if left <= 0:
                raise TimeoutError(
                    f"request {rid} still running after {budget}s" + (
                        "" if timeout is not None else
                        " (service default result_timeout_s — pass an "
                        "explicit timeout to wait longer)"))

    def results(self, rids: Sequence[int],
                timeout: Optional[float] = None) -> List[ServeResponse]:
        """`result` for many ids; the default-deadline / dead-handler
        guarantees apply per id."""
        return [self.result(r, timeout=timeout) for r in rids]

    def forget(self, rid: int) -> None:
        with self._lock:
            self._requests.pop(rid, None)

    def _rec(self, rid: int) -> _InFlight:
        with self._lock:
            try:
                return self._requests[rid]
            except KeyError:
                raise KeyError(f"unknown request id {rid}") from None

    # -- introspection / lifecycle -----------------------------------------

    def stats(self) -> Dict[str, Dict]:
        """Per-tenant engine stats — cross-request batch occupancy shows
        up as ``submits / drains`` (and in ``max_batch``)."""
        with self._lock:
            tenants = dict(self._tenants)
        return {name: t.engine.stats.as_dict()
                for name, t in tenants.items()}

    def health(self) -> Dict:
        """Liveness/pressure snapshot for monitoring and admission logic.

        ``ok`` is True iff the service accepts work and every batcher
        thread is alive; ``queue_depth`` is the per-tenant count of
        submissions waiting for a drain wave; ``retries``/``quarantined``
        surface the engines' fault counters so silent fault-healing is
        visible from outside. Each call also sweeps orphaned search
        checkpoints older than ``checkpoint_gc_age_s`` from the store
        (`ArtifactStore.gc_checkpoints` — health polling doubles as the
        GC heartbeat); ``checkpoint_gc`` reports the sweep."""
        evicted: Tuple[str, ...] = ()
        if self.checkpoint_gc_age_s is not None:
            evicted = self.store.gc_checkpoints(self.checkpoint_gc_age_s)
            self._ckpt_gc_evicted += len(evicted)
        remaining = sum(k.startswith("search_ckpt-")
                        for k in self.store.keys())
        with self._lock:
            tenants = dict(self._tenants)
            batchers = [th for th, _ in self._batchers.values()]
            inflight = self._n_inflight
            tracked = len(self._requests)
        batchers_alive = all(th.is_alive() for th in batchers)
        closing = self._closing.is_set()
        return {
            "ok": not closing and batchers_alive,
            "closing": closing,
            "tenants": sorted(tenants),
            "inflight": inflight,
            "max_inflight": self.max_inflight,
            "requests_tracked": tracked,
            "batchers": {"count": len(batchers),
                         "alive": sum(th.is_alive() for th in batchers)},
            "queue_depth": {name: t.engine.pending()
                            for name, t in tenants.items()},
            "retries": {name: t.engine.stats.retries
                        for name, t in tenants.items()},
            "quarantined": {name: t.engine.stats.quarantined
                            for name, t in tenants.items()},
            "checkpoint_gc": {"evicted_now": len(evicted),
                              "evicted_total": self._ckpt_gc_evicted,
                              "remaining": remaining},
        }

    def close(self) -> None:
        """Finish in-flight work, then stop the batchers and the pool.

        Order matters: the request pool drains FIRST, while the batchers
        are still serving — a mid-flight handler (e.g. a DSE generation)
        may submit more queries, and stopping the batchers early would
        leave those futures unresolved until the view timeout. Only once
        every handler has returned do the batchers stop and abort
        whatever (nothing, by then) remains queued."""
        self._closing.set()                # reject new submissions
        self._pool.shutdown(wait=True)     # let in-flight handlers finish
        self._stop.set()                   # now stop the batchers
        with self._lock:
            batchers = list(self._batchers.values())
        for th, _ in batchers:
            th.join(timeout=10.0)

    def __enter__(self) -> "EvalService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ==========================================================================
# the LM continuous-batching server
# ==========================================================================

@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


class BatchServer:
    """Slot-based continuous batching on one decode step.

    A fixed decode batch of ``slots`` rows runs `make_decode_step`'s
    step; a finished sequence releases its slot, which is refilled from
    the queue. A request is admitted by stepping its prompt through the
    decode step one token at a time, and each decode wave steps every
    active slot once. The bookkeeping is the reference's
    (`repro.launch.serve.BatchServer`), the last prompt token fed again
    as the first decode input included; a step writes only the stepped
    slot's cache row (``row``) and admission empties the slot's row
    (`decoding.clear_row`), where the reference's step writes every row
    at the stepped slot's position and admission leaves the previous
    request's entries in place. The cache lives on ``device`` (the card
    unless it says otherwise), beside ``params``; ``kv_int8`` stores it
    as int8 with per-(slot, head) scales (the stacked families only,
    `decoding.cache_spec`).
    """

    def __init__(self, cfg, params, slots: int = 4, max_len: int = 128,
                 device=None, kv_int8: bool = False):
        from repro_torch import device as device_lib
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import steps
        from repro_torch.models import decoding

        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.device = device_lib.resolve(device)
        self.shape = ShapeConfig("serve", max_len, slots, "decode")
        self.cache = decoding.init_cache(cfg, self.shape, self.device,
                                         kv_int8=kv_int8)
        self.pos = np.zeros(slots, np.int32)       # next position per slot
        self.active: List[Optional[Request]] = [None] * slots
        self._decode = steps.make_decode_step(cfg)
        self._clear_row = decoding.clear_row
        self.steps = 0

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    def admit(self, req: Request) -> bool:
        slot = self._free_slot()
        if slot is None:
            return False
        self.active[slot] = req
        self.pos[slot] = 0
        self._clear_row(self.cfg, self.cache, slot)
        for tok in req.prompt:
            self._step_slot(slot, int(tok))
        return True

    def _step_slot(self, slot: int, token: int) -> int:
        import torch
        toks = torch.zeros((self.slots, 1), dtype=torch.int32)
        toks[slot, 0] = token
        with torch.inference_mode():
            logits, self.cache = self._decode(
                self.params, self.cache, toks.to(self.device),
                int(self.pos[slot]), row=slot)
            nxt = int(logits[slot, -1].argmax())
        self.pos[slot] += 1
        self.steps += 1
        return nxt

    def run(self, queue_: List[Request]) -> Dict[int, List[int]]:
        """Serve every request of ``queue_``; returns {rid: tokens}."""
        queue_ = list(queue_)
        served = {}
        pending: Dict[int, int] = {}      # slot -> last token
        while queue_ or any(self.active):
            while queue_ and self._free_slot() is not None:
                req = queue_.pop(0)
                self.admit(req)
                pending[self.active.index(req)] = int(req.prompt[-1])
            # one decode wave: advance every active slot by one token
            for slot, req in enumerate(self.active):
                if req is None:
                    continue
                nxt = self._step_slot(slot, pending.get(slot, 0))
                req.out.append(nxt)
                pending[slot] = nxt
                if len(req.out) >= req.max_new:
                    req.done = True
                    served[req.rid] = req.out
                    self.active[slot] = None
                    pending.pop(slot, None)
        return served


# ==========================================================================
# demos
# ==========================================================================

def _demo_eval(args) -> None:
    """Fire concurrent predict, label and dse sessions at a service whose
    tenant is the library proxy, its labels from the batched oracle on
    ``--device`` (default: the CUDA card): each client's first request
    is a label, the rest predicts."""
    from repro_torch import device as device_lib
    from repro_torch.core import pipeline as P
    from repro_torch.core.engine import SurrogateEngine
    from repro_torch.core.islands import library_proxy_evaluator

    dev = device_lib.resolve(args.device)
    ctx = P.app_context(args.app, device=dev)
    sizes = [len(ctx.entries[n.kind]) for n in ctx.app.unit_nodes]

    with EvalService(coalesce=True) as svc:
        svc.register(args.app, library_proxy_evaluator(ctx.app, ctx.entries),
                     sizes, oracle_builder=lambda: SurrogateEngine.from_oracle(
                         ctx.app, ctx.entries, ctx.inp, ctx.exact_out))
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        rids = []
        for c in range(args.clients):
            for r in range(args.requests_per_client):
                cfgs = [tuple(int(rng.integers(0, s)) for s in sizes)
                        for _ in range(args.configs_per_request)]
                kind = "label" if r == 0 else "predict"
                rids.append(svc.submit(ServeRequest(kind, args.app,
                                                    configs=cfgs)))
        dse_rid = svc.submit(ServeRequest("dse", args.app, sampler="nsga3",
                                          budget=args.dse_budget, seed=0,
                                          dse_kwargs={"pop": 16}))
        for entry in svc.stream(dse_rid):
            print(f"  dse gen {entry['generation']}: front="
                  f"{entry['front_size']} hv={entry['hypervolume']:.4g}")
        resps = svc.results(rids + [dse_rid])
        dt = time.perf_counter() - t0
        assert all(r.ok for r in resps), [r.error for r in resps]
        lat = sorted(r.latency_s for r in resps)
        st = svc.stats()[args.app]
        print(f"served {len(resps)} requests on {dev} in {dt:.2f}s "
              f"({len(resps) / dt:.1f} req/s), "
              f"P50 {lat[len(lat) // 2] * 1e3:.1f}ms "
              f"P99 {lat[int(len(lat) * 0.99)] * 1e3:.1f}ms")
        print(f"engine: occupancy={st['batch_occupancy']} "
              f"max_batch={st['max_batch']} hit_rate={st['cache_hit_rate']}")


def _demo_lm(args) -> None:
    """Serve ``--requests`` random prompts through ``--slots`` slots of a
    model with random weights (seed 0) on ``--device``."""
    import torch

    from repro_torch import device as device_lib
    from repro_torch.configs import ARCHS, REDUCED_ARCHS
    from repro_torch.models import transformer

    dev = device_lib.resolve(args.device)
    cfg = (REDUCED_ARCHS if args.reduced else ARCHS)[args.arch]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = transformer.build_param_table(cfg).init(
        gen, device=dev, dtype=getattr(torch, cfg.dtype))
    server = BatchServer(cfg, params, slots=args.slots, device=dev)

    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, args.prompt_len),
                    args.max_new) for i in range(args.requests)]
    t0 = time.time()
    server.run(reqs)
    dt = time.time() - t0
    total_tokens = sum(len(r.out) for r in reqs)
    print(f"served {len(reqs)} requests on {dev}, {total_tokens} tokens, "
          f"{server.steps} decode steps, {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s)")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {[int(t) for t in r.prompt]} -> {r.out}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--demo", choices=("eval", "lm"), default="eval")
    # eval-service demo
    ap.add_argument("--app", default="sobel")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests-per-client", type=int, default=8)
    ap.add_argument("--configs-per-request", type=int, default=16)
    ap.add_argument("--dse-budget", type=int, default=256)
    # lm demo; as in the reference, --reduced is on and cannot be turned
    # off from the command line (chip_smoke.py serves the full width)
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for "
                         "the plain path)")
    args = ap.parse_args()
    (_demo_eval if args.demo == "eval" else _demo_lm)(args)


if __name__ == "__main__":
    main()
