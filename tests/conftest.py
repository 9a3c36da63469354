"""Shared pytest configuration: markers + `hypothesis` fallback shim.

Four test modules (test_units, test_library_apps, test_substrate,
test_gnn_core) use hypothesis property tests. The runtime environment may
not have hypothesis installed, and a hard import failure used to kill the
*entire* suite at collection time. When the real package is missing we
install a tiny deterministic stand-in into ``sys.modules`` before the test
modules are imported: each ``@given`` test runs on boundary values plus a
seeded random sample, so the properties are still exercised (with fewer
examples) instead of being skipped wholesale.

Only the slice of the hypothesis API used by this repo is provided:
``given``, ``settings``, ``strategies.integers``, ``strategies.sampled_from``.
Install the real `hypothesis` (see requirements.txt) for full shrinking
and coverage.
"""
from __future__ import annotations

import inspect
import sys
import types
import zlib

import numpy as np


def pytest_configure(config):
    # `slow` marks multi-second tests (training runs, concurrency soak
    # loops). Tier-1 runs them by default; CI lanes that need a quick
    # signal can deselect with ``-m "not slow"``.
    config.addinivalue_line(
        "markers", "slow: multi-second test (deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one)")


try:
    import hypothesis  # noqa: F401  (real package wins when available)
except ImportError:
    _MAX_EXAMPLES_CAP = 25   # keep the fallback fast; real runs use the pkg

    class _Strategy:
        """A value generator: seeded random draw + explicit boundary cases."""

        def __init__(self, draw, boundary=()):
            self._draw = draw
            self.boundary = tuple(boundary)

        def example(self, rng):
            return self._draw(rng)

    def _integers(min_value, max_value):
        return _Strategy(
            lambda rng: int(rng.integers(min_value, max_value + 1)),
            boundary=(min_value, max_value))

    def _sampled_from(elements):
        seq = list(elements)
        return _Strategy(lambda rng: seq[int(rng.integers(len(seq)))],
                         boundary=(seq[0], seq[-1]))

    def _given(*strategies):
        def deco(fn):
            def wrapper():
                n = min(getattr(wrapper, "_stub_max_examples", 20),
                        _MAX_EXAMPLES_CAP)
                rng = np.random.default_rng(
                    zlib.crc32(fn.__qualname__.encode()))
                n_bound = max((len(s.boundary) for s in strategies),
                              default=0)
                cases = [tuple(s.boundary[min(i, len(s.boundary) - 1)]
                               for s in strategies)
                         for i in range(n_bound)]
                while len(cases) < n:
                    cases.append(tuple(s.example(rng) for s in strategies))
                for args in cases:
                    fn(*args)

            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            # pytest must not see the sampled parameters as fixtures
            wrapper.__signature__ = inspect.Signature()
            return wrapper
        return deco

    def _settings(max_examples=20, deadline=None, **_kw):
        def deco(fn):
            fn._stub_max_examples = max_examples
            return fn
        return deco

    _mod = types.ModuleType("hypothesis")
    _mod.__doc__ = "Deterministic mini-hypothesis fallback (see conftest.py)"
    _strat = types.ModuleType("hypothesis.strategies")
    _strat.integers = _integers
    _strat.sampled_from = _sampled_from
    _mod.given = _given
    _mod.settings = _settings
    _mod.strategies = _strat
    sys.modules["hypothesis"] = _mod
    sys.modules["hypothesis.strategies"] = _strat
