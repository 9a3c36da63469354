"""Fault tolerance, straggler detection and the elastic scaling plan.

The same semantics as `repro.distributed.fault`, kept here so the port
imports nothing of the JAX package:

  * FaultInjector      deterministic step-indexed faults (host crash, NaN
                       corruption, straggler stall); `wrap(evaluate)`
                       applies the same schedule to a batch evaluator by
                       call index (`FaultyEvaluator`);
  * RetryPolicy        bounded exponential backoff for transient faults
                       only (`TransientError` and subclasses); its
                       ``call(fn, arg, on_retry=)`` is the hook that
                       `core.engine.SurrogateEngine` takes as ``retry=``;
  * HealthMonitor      per-step wall-time EWMA; a step slower than
                       ``straggler_factor`` x EWMA is flagged a straggler;
  * elastic_plan       the mesh shape and batch re-split for a changed
                       device count, preserving the global batch.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import (Callable, Dict, List, Optional, Sequence, Tuple,
                    Type)

import numpy as np


class TransientError(RuntimeError):
    """A fault that a bounded retry can heal: the faulting call is expected
    to succeed if simply re-issued (crashed host replaced, stall passed).
    `RetryPolicy` retries these and nothing else."""


class HostFailure(TransientError):
    pass


class StragglerStall(TransientError):
    pass


@dataclass
class FaultInjector:
    crash_at: Sequence[int] = ()
    nan_at: Sequence[int] = ()
    stall_at: Sequence[int] = ()
    stall_seconds: float = 0.2
    fired: set = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.crash_at and ("crash", step) not in self.fired:
            self.fired.add(("crash", step))
            raise HostFailure(f"injected host failure at step {step}")
        if step in self.stall_at and ("stall", step) not in self.fired:
            self.fired.add(("stall", step))
            time.sleep(self.stall_seconds)

    def corrupt(self, step: int) -> bool:
        if step in self.nan_at and ("nan", step) not in self.fired:
            self.fired.add(("nan", step))
            return True
        return False

    def wrap(self, evaluate: Callable, nan_rows: int = 1
             ) -> "FaultyEvaluator":
        """Chaos wrapper for a batch evaluator: the crash/nan/stall
        schedule fires by *call index* instead of train step."""
        return FaultyEvaluator(evaluate, self, nan_rows=nan_rows)


class FaultyEvaluator:
    """A batch evaluator that injects its `FaultInjector`'s schedule.

    The wrapped ``evaluate(configs) -> (n, n_obj)`` callable is invoked
    normally; faults fire deterministically by this wrapper's own call
    counter (0-based), each exactly once:

      * ``crash_at``: raise `HostFailure` *before* the backend runs — a
        transient fault the engine's `RetryPolicy` heals by re-issuing
        the call (the retry lands on the next call index);
      * ``nan_at``:   corrupt the first ``nan_rows`` returned rows to NaN
        — caught by `SurrogateEngine`'s non-finite-row guard, which
        re-evaluates the offending configs individually;
      * ``stall_at``: sleep ``stall_seconds`` before evaluating — a
        straggler; results are unaffected, only latency.

    Because every fault fires once and the underlying evaluator is
    deterministic, a retrying/guarded consumer recovers rows bit-identical
    to the fault-free evaluator (the chaos-harness property).
    """

    def __init__(self, evaluate: Callable, injector: FaultInjector,
                 nan_rows: int = 1):
        self.evaluate = evaluate
        self.injector = injector
        self.nan_rows = int(nan_rows)
        self.calls = 0

    def __call__(self, configs):
        idx = self.calls
        self.calls += 1
        self.injector.check(idx)          # may raise HostFailure / stall
        rows = np.asarray(self.evaluate(configs))
        if self.injector.corrupt(idx) and len(rows):
            rows = np.array(rows, np.float64, copy=True)
            rows[:min(self.nan_rows, len(rows))] = np.nan
        return rows


@dataclass
class RetryPolicy:
    """Bounded exponential backoff for transient evaluator faults.

    ``max_attempts`` counts every try including the first; an operation
    is re-issued only while the raised exception is an instance of one of
    ``retry_on`` (default: `TransientError` — injectable faults like
    `HostFailure`/`StragglerStall`). Deterministic failures propagate on
    the first raise. Delays grow ``base_delay_s * multiplier**attempt``,
    clamped to ``max_delay_s``.
    """
    max_attempts: int = 3
    base_delay_s: float = 0.01
    max_delay_s: float = 0.5
    multiplier: float = 2.0
    retry_on: Tuple[Type[BaseException], ...] = (TransientError,)

    def retryable(self, exc: BaseException, attempt: int) -> bool:
        """True if the `attempt`-th try (0-based) may be re-issued."""
        return (attempt + 1 < self.max_attempts
                and isinstance(exc, self.retry_on))

    def delay_s(self, attempt: int) -> float:
        return min(self.base_delay_s * self.multiplier ** attempt,
                   self.max_delay_s)

    def sleep(self, attempt: int) -> None:
        d = self.delay_s(attempt)
        if d > 0:
            time.sleep(d)

    def call(self, fn: Callable, *args, on_retry: Optional[Callable] = None):
        """Run ``fn(*args)`` under this policy; `on_retry` (if given) is
        called with the exception before each re-issue — the engine uses
        it to count retries into `EngineStats`."""
        attempt = 0
        while True:
            try:
                return fn(*args)
            except BaseException as e:    # noqa: BLE001 — filtered below
                if not self.retryable(e, attempt):
                    raise
                if on_retry is not None:
                    on_retry(e)
                self.sleep(attempt)
                attempt += 1


@dataclass
class HealthMonitor:
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    ewma: Optional[float] = None
    stragglers: List[int] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.step_times.append(dt)
        is_straggler = (self.ewma is not None
                        and dt > self.straggler_factor * self.ewma
                        and len(self.step_times) > 3)
        if is_straggler:
            self.stragglers.append(step)
        else:  # stragglers don't poison the baseline
            self.ewma = dt if self.ewma is None else \
                (1 - self.ewma_alpha) * self.ewma + self.ewma_alpha * dt
        return is_straggler


def elastic_plan(n_devices: int, global_batch: int,
                 prefer_model: int = 16) -> Dict[str, int]:
    """Mesh + batch plan for a changed device count (elastic scaling).

    Keeps the model axis as close to `prefer_model` as divisibility allows
    and preserves the global batch via grad accumulation."""
    model = 1
    for m in range(min(prefer_model, n_devices), 0, -1):
        if n_devices % m == 0:
            model = m
            break
    data = n_devices // model
    accum = 1
    while global_batch % (data * accum) != 0 or \
            global_batch // (data * accum) > 64:
        accum += 1
        if accum > global_batch:
            accum = 1
            break
    return {"data": data, "model": model, "grad_accum": accum,
            "per_shard_batch": global_batch // max(data, 1)}
