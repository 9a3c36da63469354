"""`repro_torch.distributed.fault` against `repro.distributed.fault`: the
same schedules, seeds and step times give the same faults, retries,
stragglers and plans in both packages, and the port's `RetryPolicy` and
`FaultyEvaluator` heal the port engine's rows bit-identically through its
``retry=`` hook. Everything here is exact: no float tolerance."""
import numpy as np
import pytest

from repro.distributed import fault as jfault
from repro_torch.core.engine import SurrogateEngine
from repro_torch.distributed import fault as tfault


def _toy_eval(configs):
    a = np.asarray(configs, np.float64).reshape(len(configs), -1)
    return np.stack([a.sum(1), (a * a).sum(1), a.max(1)], 1)


def _configs(n=60, seed=0):
    rng = np.random.default_rng(seed)
    return [tuple(int(v) for v in rng.integers(0, 9, 3)) for _ in range(n)]


def _schedule(seed, n_calls=20):
    rng = np.random.default_rng(seed)
    return dict(crash_at=tuple(int(i) for i in rng.integers(0, n_calls, 3)),
                nan_at=tuple(int(i) for i in rng.integers(0, n_calls, 3)),
                stall_at=tuple(int(i) for i in rng.integers(0, n_calls, 2)),
                stall_seconds=0.0)


def _trace(pkg, schedule, n_calls=20):
    """What the injector and its evaluator wrapper do at each call index:
    raise, corrupt rows, or pass clean rows."""
    ev = pkg.FaultInjector(**schedule).wrap(_toy_eval, nan_rows=2)
    out = []
    cfgs = _configs(4)
    for _ in range(n_calls):
        try:
            rows = ev(cfgs)
        except pkg.HostFailure:
            out.append("crash")
            continue
        out.append(np.isnan(rows).any(1).tolist())
    return out, sorted(ev.injector.fired), ev.calls


@pytest.mark.parametrize("seed", range(6))
def test_injector_and_evaluator_match_the_reference(seed):
    s = _schedule(seed)
    assert _trace(tfault, s) == _trace(jfault, s)
    inj = tfault.FaultInjector(crash_at=(2,), nan_at=(1,), stall_at=(3,),
                               stall_seconds=0.0)
    inj.check(0)
    with pytest.raises(tfault.HostFailure):
        inj.check(2)
    inj.check(2)
    assert inj.corrupt(1) and not inj.corrupt(1)
    inj.check(3)
    assert ("stall", 3) in inj.fired and not inj.corrupt(0)
    assert issubclass(tfault.HostFailure, tfault.TransientError)
    assert issubclass(tfault.StragglerStall, tfault.TransientError)


def _retry_trace(pkg, fail_first, max_attempts, exc_name):
    pol = pkg.RetryPolicy(max_attempts=max_attempts, base_delay_s=0.0)
    state = {"n": 0, "retries": []}

    def fn(x):
        state["n"] += 1
        if state["n"] <= fail_first:
            raise (ValueError if exc_name == "ValueError"
                   else getattr(pkg, exc_name))("fault")
        return x * 2

    try:
        out = pol.call(fn, 21, on_retry=lambda e: state["retries"].append(
            type(e).__name__))
    except (pkg.TransientError, ValueError) as e:
        out = type(e).__name__
    return out, state["n"], state["retries"]


@pytest.mark.parametrize("fail_first,max_attempts,exc", [
    (0, 3, "HostFailure"), (2, 3, "HostFailure"), (3, 3, "StragglerStall"),
    (1, 1, "TransientError"), (1, 4, "ValueError")])
def test_retry_policy_matches_the_reference(fail_first, max_attempts, exc):
    """Heals transient faults within its budget, propagates past it, never
    re-issues a deterministic error; the backoff delays are the
    reference's."""
    assert _retry_trace(tfault, fail_first, max_attempts, exc) == \
        _retry_trace(jfault, fail_first, max_attempts, exc)
    for kw in ({}, dict(base_delay_s=0.1, multiplier=10.0, max_delay_s=0.5)):
        tp, jp = tfault.RetryPolicy(**kw), jfault.RetryPolicy(**kw)
        assert [tp.delay_s(a) for a in range(5)] == \
            [jp.delay_s(a) for a in range(5)]


@pytest.mark.parametrize("seed", range(4))
def test_engine_retry_hook_heals_faults_bit_identically(seed):
    """The port engine under the port's `RetryPolicy` and a chaos
    schedule: rows equal to the fault-free engine's, and the same retry
    and quarantine counts as the reference engine on the same schedule."""
    from repro.core.engine import SurrogateEngine as JEngine
    cfgs = _configs(60, seed)
    clean = SurrogateEngine(_toy_eval)(cfgs)
    s = dict(_schedule(seed, n_calls=8), stall_at=())
    counts = []
    for pkg, Eng in ((tfault, SurrogateEngine), (jfault, JEngine)):
        eng = Eng(pkg.FaultInjector(**s).wrap(_toy_eval, nan_rows=3),
                  chunk_size=16,
                  retry=pkg.RetryPolicy(max_attempts=4, base_delay_s=0.0),
                  nan_retries=3)
        np.testing.assert_array_equal(eng(cfgs), clean)
        counts.append((eng.stats.retries, eng.stats.quarantined,
                       eng.stats.evaluated))
    assert counts[0] == counts[1]
    assert counts[0][0] > 0             # the schedule did fire


def test_health_monitor_matches_the_reference():
    rng = np.random.default_rng(5)
    times = rng.exponential(1.0, 200) * np.where(rng.random(200) < 0.1,
                                                 8.0, 1.0)
    tm, jm = tfault.HealthMonitor(), jfault.HealthMonitor()
    flags = [(tm.record(i, float(t)), jm.record(i, float(t)))
             for i, t in enumerate(times)]
    assert all(a == b for a, b in flags) and any(a for a, _ in flags)
    assert tm.stragglers == jm.stragglers and tm.ewma == jm.ewma
    mon = tfault.HealthMonitor(straggler_factor=3.0)
    assert not any(mon.record(i, 1.0) for i in range(4))
    before = mon.ewma
    assert mon.record(4, 10.0) and mon.stragglers == [4]
    assert mon.ewma == before and not mon.record(5, 1.0)


def test_elastic_plan_matches_the_reference():
    for n in range(1, 65):
        for gb in (64, 128, 256, 512, 96):
            assert tfault.elastic_plan(n, gb) == jfault.elastic_plan(n, gb)
