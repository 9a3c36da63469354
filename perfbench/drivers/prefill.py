"""Prefill traffic: a closed loop of one caller, back-to-back prefill
calls of `launch/steps.py::make_prefill_step`, each on a fresh batch
drawn ahead of it (`pbench.generator`) and timed from the call to
`synchronize()`.

The caches of the last ``live_calls`` calls stay on the card, as a
deployment keeps its live requests' caches until they are decoded or
handed on; set-up fills that pool with blocks of one call's cache size
that the window's calls then replace. One call of each shape, drawn from
the seed among the window's calls of that shape, keeps its logits and
cache for the comparison.

Faults planted under the timed path for the tests and `calibrate.py`
(a run of the benchmark plants none): ``state_unchanged`` (the cache
comes back empty, as `init_cache` makes it), ``half_batch`` (the second
half of the prompts left out, their rows filled with the first half's),
``answer_altered`` (two prompts' logits swapped).
"""
from __future__ import annotations

import collections
import gc
import random
import time
from typing import Dict, List, Optional

import torch

from pbench import compare, generator, program, tracing, weights

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def plant(prog, fault: Optional[str]):
    """``prog`` (params, batch) -> (logits, cache) with ``fault``."""
    if fault is None:
        return prog
    if fault not in FAULTS:
        raise ValueError(f"prefill fault {fault!r}; one of {FAULTS}")

    def call(params, batch):
        logits, cache = prog(params, batch)
        entries = prog.cache_entries(cache)
        half = logits.shape[0] // 2
        if fault == "state_unchanged":
            for name, layer in entries.items():
                for t in layer:
                    t.fill_(-1 if name == "pos" else 0)
        elif fault == "half_batch":
            logits[half:2 * half] = logits[:half]
            for layer in entries.values():
                for t in layer:
                    t[half:2 * half] = t[:half]
        else:
            logits[[0, 1]] = logits[[1, 0]]
        return logits, cache
    return call


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _nbytes(cache: dict) -> int:
    return sum(t.numel() * t.element_size() for t in cache.values())


class Driver:

    def __init__(self, conf: dict, mix: dict, seed: int, device,
                 reference, fault: Optional[str] = None):
        self.conf, self.mix, self.seed = conf, mix, seed
        self.device = torch.device(device)
        self.ref = reference
        self.fault = fault
        self.dtype = getattr(torch, conf["dtype"])
        self.stats: Dict[str, object] = {}
        self.phases: Dict[str, float] = {}
        self.traced: List[dict] = []      # the shapes of a traced slice
        self.next_index = 0               # the batch of the next call
        self.nonfinite = torch.zeros((), dtype=torch.int64,
                                     device=self.device)
        self.live = collections.deque(maxlen=mix["live_calls"])

    def attempted(self) -> int:
        return self.stats["calls"]

    def batch(self, index: int):
        return generator.make_batch(self.conf, self.mix, self.seed, index,
                                    self.device)

    def draw_weights(self):
        return weights.make(self.ref.declare(self.conf), self.seed,
                            self.device, self.dtype)

    def setup(self) -> None:
        """The program, its weights, the pool of live caches, the warm-up
        calls; ``phases`` gets each one's seconds."""
        t = [time.perf_counter()]

        def lap(name):
            _sync(self.device)
            t.append(time.perf_counter())
            self.phases[name] = t[-1] - t[-2]
        self.prog = program.Prefill(self.conf)
        lap("program")
        flat = self.draw_weights()
        program.check_weights(self.prog.cfg, flat)
        self.params = weights.nest(flat)
        self.call = plant(self.prog, self.fault)
        lap("weights")
        size = _nbytes(self.timed_call(-1)[1])
        lap("first_call")
        while len(self.live) < self.live.maxlen:
            self.live.appendleft(torch.empty(size, dtype=torch.uint8,
                                             device=self.device))
        lap("live_pool")
        for i in range(1, self.mix["warmup_rounds"]
                       * len(self.mix["shapes"])):
            self.timed_call(-1 - i)
        lap("warmup")

    def timed_call(self, index: int):
        batch = self.batch(index)
        _sync(self.device)
        t = time.perf_counter()
        with torch.inference_mode():
            logits, cache = self.call(self.params, batch)
        _sync(self.device)
        dt = time.perf_counter() - t
        self.live.append(cache)
        return logits, cache, dt

    def window(self, seconds: float) -> None:
        rng = random.Random(weights.derive(self.seed, "sample"))
        self.kept: Dict[int, tuple] = {}          # shape -> (index, ...)
        seen = collections.Counter()
        times, shapes = [], []
        start = time.perf_counter()
        i = 0
        while True:
            shape = generator.shape_of(self.mix, self.seed, i)
            logits, cache, dt = self.timed_call(i)
            times.append(dt)
            shapes.append(shape)
            self.nonfinite += (~torch.isfinite(logits)).any()
            # a reservoir a shape: each call of it kept with equal odds
            k = self.mix["shapes"].index(shape)
            seen[k] += 1
            if rng.randrange(seen[k]) == 0:
                self.kept[k] = (i, logits, cache)
            i += 1
            # every shape runs, and is checked, in every window
            if i >= len(self.mix["shapes"]) and \
                    time.perf_counter() - start >= seconds:
                break
        self.stats = {"calls": i, "seconds": time.perf_counter() - start,
                      "call_s": times, "shapes": shapes,
                      "tokens": sum(generator.tokens(s) for s in shapes)}
        self.next_index = i

    def trace(self) -> tracing.Trace:
        """``traced_rounds`` blocks of calls, every shape in each, under
        the profiler, in each of its slices."""
        n = len(self.mix["shapes"])
        rounds = self.mix["traced_rounds"]

        def run():
            first = -(-self.next_index // n) * n
            self.next_index = first + rounds * n
            self.traced = [generator.shape_of(self.mix, self.seed, i)
                           for i in range(first, self.next_index)]
            for i in range(first, self.next_index):
                self.timed_call(i)
        return tracing.record(run, program.spans())

    def release(self) -> None:
        del self.params, self.call
        self.live.clear()
        _free(self.device)

    def reference_run(self, precision: str = "float32") -> List[tuple]:
        """The reference over each checked call's batch: [(logits,
        cache)], from weights drawn again."""
        w = self.draw_weights()
        out = [self.ref.prefill(self.conf, w, self.batch(self.kept[k][0]),
                                precision) for k in sorted(self.kept)]
        del w
        _free(self.device)
        return out

    def numbers(self, refs: List[tuple], got=None) -> List[Dict[str, float]]:
        """Each checked call's numbers; ``got`` puts other outputs (the
        control's) in the program's place."""
        out = []
        for j, (k, (ref_logits, ref_cache)) in enumerate(
                zip(sorted(self.kept), refs)):
            if got is None:
                _, logits, cache = self.kept[k]
                entries = self.prog.cache_entries(cache)
            else:
                logits, entries = got[j]
            out.append(compare.prefill_numbers(logits, entries, ref_logits,
                                               ref_cache))
        return out
