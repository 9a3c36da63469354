"""The port's `EvalService` on the CPU: tests/test_serve.py and the
service tests of tests/test_fault_dse.py against
`repro_torch.launch.serve`, a cross-package script sent to both
packages' services, and a tenant warmed from the port's staged pipeline.

Exactness strategy, as in the reference's tests: the proxy evaluator is
pure row-independent NumPy, so fused cross-request batches cannot perturb
rows, and a warm-started tenant serves the engine object `run_staged`
memoized, so repeated configs are memo hits with identical floats.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro.accel import apps as japps
from repro.core import islands as jislands
from repro.launch import serve as jserve
from repro_torch.accel import apps as tapps
from repro_torch.accel import batch_oracle as tbo
from repro_torch.core import dataset as tds
from repro_torch.core import dse as dse_lib
from repro_torch.core import gnn as tgnn
from repro_torch.core import models as tmodels
from repro_torch.core import pipeline as P
from repro_torch.core import pruning
from repro_torch.core.artifacts import ArtifactStore
from repro_torch.core.dse import as_engine, drain_steps, nsga_steps
from repro_torch.core.engine import SurrogateEngine
from repro_torch.core.islands import library_proxy_evaluator
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import (EvalService, ServeRequest,
                                      ServiceOverloaded)

APP = "sobel"
SIZES = (5, 4, 3)


@pytest.fixture(scope="module")
def space():
    app = tapps.APPS[APP]
    pruned, _ = pruning.prune_library()
    entries = {k: pruned[k] for k in {n.kind for n in app.unit_nodes}}
    sizes = [len(entries[n.kind]) for n in app.unit_nodes]
    return app, entries, sizes


def _proxy(space):
    app, entries, _ = space
    return library_proxy_evaluator(app, entries)


def _rand_configs(sizes, n, seed):
    rng = np.random.default_rng(seed)
    return [tuple(int(rng.integers(0, s)) for s in sizes)
            for _ in range(n)]


def _toy_eval(configs):
    """Deterministic pure-NumPy 4-objective toy evaluator."""
    X = np.asarray(configs, np.float64)
    return np.stack([X.sum(1) + 1.0, ((X - 1.0) ** 2).sum(1) + 1.0,
                     (X[:, 0] - X[:, -1]) ** 2 + 1.0,
                     np.cos(X).sum(1) + 2.0], 1)


def _assert_same_result(res, base):
    assert res.pareto_configs == base.pareto_configs
    assert np.array_equal(res.pareto_objs, base.pareto_objs)
    assert res.history == base.history    # full dicts, exact floats


def _run_workload(space, *, coalesce, n_clients=8, per_client=4,
                  dse_clients=2):
    """Interleaved predict + dse workload; returns (responses, stats)."""
    _, _, sizes = space
    with EvalService(coalesce=coalesce) as svc:
        svc.register(APP, _proxy(space), sizes)
        rids = {}
        barrier = threading.Barrier(n_clients)

        def client(c):
            barrier.wait()         # maximize interleaving
            mine = []
            for r in range(per_client):
                if c < dse_clients and r == 0:
                    req = ServeRequest(
                        "dse", APP, sampler="nsga2" if c % 2 else "nsga3",
                        budget=96, seed=c, dse_kwargs={"pop": 12})
                else:
                    req = ServeRequest(
                        "predict", APP,
                        configs=_rand_configs(sizes, 16, 1000 * c + r))
                mine.append(svc.submit(req))
            rids[c] = mine

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        resps = {c: svc.results(r, timeout=120.0) for c, r in rids.items()}
        stats = svc.stats()[APP]
    return resps, stats


# --------------------------------------------------------------------------
# tests/test_serve.py on the port
# --------------------------------------------------------------------------

def test_concurrent_workload_bit_identical_to_one_shot(space):
    """8 threads of interleaved predict/dse == fresh one-shot engines."""
    _, _, sizes = space
    resps, _ = _run_workload(space, coalesce=True)
    reference = as_engine(_proxy(space))   # fresh, never saw the service
    for c, client_resps in resps.items():
        for r, resp in enumerate(client_resps):
            assert resp.ok, resp.error
            if resp.kind == "predict":
                expect = reference(_rand_configs(sizes, 16, 1000 * c + r))
                assert np.array_equal(resp.value, np.asarray(expect))
            else:
                one_shot = dse_lib.SAMPLERS[
                    "nsga2" if c % 2 else "nsga3"](
                        sizes, as_engine(_proxy(space)), 96,
                        seed=c, pop=12)
                _assert_same_result(resp.value, one_shot)


def test_deterministic_across_service_runs(space):
    """The same concurrent workload twice -> identical responses."""
    a, _ = _run_workload(space, coalesce=True)
    b, _ = _run_workload(space, coalesce=True)
    assert sorted(a) == sorted(b)
    for c in a:
        for ra, rb in zip(a[c], b[c]):
            assert (ra.kind, ra.ok) == (rb.kind, rb.ok)
            if ra.kind == "predict":
                assert np.array_equal(ra.value, rb.value)
            else:
                assert ra.value.pareto_configs == rb.value.pareto_configs
                assert ra.value.history == rb.value.history


def test_serial_mode_matches_coalesced_mode(space):
    """coalesce=False (per-request direct calls) == coalesce=True."""
    a, _ = _run_workload(space, coalesce=True, n_clients=4)
    b, _ = _run_workload(space, coalesce=False, n_clients=4)
    for c in a:
        for ra, rb in zip(a[c], b[c]):
            if ra.kind == "predict":
                assert np.array_equal(ra.value, rb.value)
            else:
                assert ra.value.history == rb.value.history


def test_cross_request_batching_coalesces(space):
    """With a slow backend and 8 concurrent clients, drains fuse several
    requests: occupancy (submits/drains) above 1 and max_batch above any
    single request's size."""
    _, _, sizes = space
    proxy = _proxy(space)

    def slow_proxy(configs):
        time.sleep(0.005)
        return proxy(configs)

    with EvalService(coalesce=True) as svc:
        svc.register(APP, slow_proxy, sizes)
        barrier = threading.Barrier(8)
        rids = []
        lock = threading.Lock()

        def client(c):
            barrier.wait()
            for r in range(4):
                rid = svc.submit(ServeRequest(
                    "predict", APP,
                    configs=_rand_configs(sizes, 8, 77 * c + r)))
                with lock:
                    rids.append(rid)
            svc.results(rids[-4:], timeout=60.0)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for resp in svc.results(rids, timeout=60.0):
            assert resp.ok, resp.error
        st = svc.stats()[APP]
    assert st["submits"] == 32
    assert st["drains"] < st["submits"], st
    assert st["batch_occupancy"] > 1.0
    assert st["max_batch"] > 8                 # fused beyond one request


def test_streamed_history_equals_final_history(space):
    _, _, sizes = space
    with EvalService(coalesce=True) as svc:
        svc.register(APP, _proxy(space), sizes)
        rid = svc.submit(ServeRequest("dse", APP, sampler="nsga3",
                                      budget=128, seed=3,
                                      dse_kwargs={"pop": 16}))
        streamed = list(svc.stream(rid))
        resp = svc.result(rid, timeout=120.0)
    assert resp.ok, resp.error
    assert streamed == resp.value.history
    assert [e["generation"] for e in streamed] == \
        list(range(len(streamed)))


def test_streamed_islands_history(space):
    """Epoch-granular streaming from the island fleet sampler."""
    _, _, sizes = space
    with EvalService(coalesce=True) as svc:
        svc.register(APP, _proxy(space), sizes)
        rid = svc.submit(ServeRequest(
            "dse", APP, sampler="islands", budget=128, seed=1,
            dse_kwargs={"n_islands": 2, "pop": 8}))
        streamed = list(svc.stream(rid))
        resp = svc.result(rid, timeout=120.0)
    assert resp.ok, resp.error
    assert streamed == resp.value.history
    one_shot = dse_lib.SAMPLERS["islands"](
        sizes, as_engine(_proxy(space)), 128, seed=1, n_islands=2, pop=8)
    assert resp.value.history == one_shot.history
    assert resp.value.pareto_configs == one_shot.pareto_configs


def test_label_requests_use_oracle(space):
    """`label` routes through the tenant oracle, not the surrogate."""
    _, _, sizes = space
    proxy = _proxy(space)

    def fake_oracle(configs):
        return np.asarray(proxy(configs)) * 2.0

    with EvalService(coalesce=True) as svc:
        svc.register(APP, proxy, sizes, oracle=fake_oracle)
        cfgs = _rand_configs(sizes, 12, 5)
        pr = svc.result(svc.submit(
            ServeRequest("predict", APP, configs=cfgs)), timeout=60.0)
        lr = svc.result(svc.submit(
            ServeRequest("label", APP, configs=cfgs)), timeout=60.0)
    assert pr.ok and lr.ok, (pr.error, lr.error)
    assert np.array_equal(lr.value, np.asarray(pr.value) * 2.0)


def test_request_errors_are_reported_not_fatal(space):
    """Bad requests error their own response; the service stays up."""
    _, _, sizes = space
    with EvalService(coalesce=True) as svc:
        svc.register(APP, _proxy(space), sizes)
        with pytest.raises(KeyError):
            svc.submit(ServeRequest("predict", "no-such-tenant",
                                    configs=[(0,) * len(sizes)]))
        bad = svc.result(svc.submit(
            ServeRequest("label", APP,
                         configs=[(0,) * len(sizes)])), timeout=60.0)
        assert not bad.ok and "oracle" in bad.error
        worse = svc.result(svc.submit(
            ServeRequest("frobnicate", APP)), timeout=60.0)
        assert not worse.ok and "frobnicate" in worse.error
        good = svc.result(svc.submit(ServeRequest(
            "predict", APP,
            configs=_rand_configs(sizes, 4, 9))), timeout=60.0)
        assert good.ok, good.error
    assert pytest.raises(RuntimeError, svc.submit,
                         ServeRequest("predict", APP, configs=[]))


def test_out_of_range_configs_rejected_at_submit(space):
    _, _, sizes = space
    with EvalService(coalesce=True) as svc:
        svc.register(APP, _proxy(space), sizes)
        with pytest.raises(ValueError, match="out of range"):
            svc.submit(ServeRequest(
                "predict", APP,
                configs=[(sizes[0],) + (0,) * (len(sizes) - 1)]))
        with pytest.raises(ValueError, match="out of range"):
            svc.submit(ServeRequest("predict", APP, configs=[(0,)]))
        ok = svc.result(svc.submit(ServeRequest(
            "predict", APP, configs=_rand_configs(sizes, 4, 0))),
            timeout=60.0)
        assert ok.ok, ok.error


def test_backend_failure_isolated_to_offending_request(space):
    """A backend exception mid-wave fails only the request that caused
    it; the batcher survives to serve later traffic."""
    _, _, sizes = space
    proxy = _proxy(space)
    poison = tuple(0 for _ in sizes)

    def flaky(configs):
        time.sleep(0.005)              # widen the coalescing window
        if poison in configs:
            raise RuntimeError("poisoned config")
        return proxy(configs)

    with EvalService(coalesce=True) as svc:
        svc.register(APP, flaky, sizes)
        barrier = threading.Barrier(8)
        rids = [None] * 8

        def client(c):
            barrier.wait()
            cfgs = ([poison] if c == 0 else
                    [tuple(max(1, int(v)) for v in cfg) for cfg in
                     _rand_configs(sizes, 8, c)])
            rids[c] = svc.submit(ServeRequest("predict", APP, configs=cfgs))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        resps = svc.results(rids, timeout=60.0)
        assert not resps[0].ok and "poisoned" in resps[0].error
        for r in resps[1:]:
            assert r.ok, r.error
        again = svc.result(svc.submit(ServeRequest(
            "predict", APP,
            configs=[tuple(1 for _ in sizes)])), timeout=60.0)
        assert again.ok, again.error


def test_reregister_retires_old_batcher(space):
    _, _, sizes = space
    with EvalService(coalesce=True) as svc:
        svc.register(APP, _proxy(space), sizes)
        assert len(svc._batchers) == 1
        (old_thread, _), = svc._batchers.values()
        svc.register(APP, _proxy(space), sizes)   # replacement
        assert len(svc._batchers) == 1
        (new_thread, _), = svc._batchers.values()
        assert new_thread is not old_thread
        old_thread.join(timeout=10.0)
        assert not old_thread.is_alive()
        ok = svc.result(svc.submit(ServeRequest(
            "predict", APP, configs=_rand_configs(sizes, 4, 0))),
            timeout=60.0)
        assert ok.ok, ok.error


def test_second_stream_returns_empty_not_blocking(space):
    _, _, sizes = space
    with EvalService(coalesce=True) as svc:
        svc.register(APP, _proxy(space), sizes)
        rid = svc.submit(ServeRequest("dse", APP, sampler="nsga3",
                                      budget=64, seed=0,
                                      dse_kwargs={"pop": 8}))
        first = list(svc.stream(rid))
        assert first
        t0 = time.perf_counter()
        assert list(svc.stream(rid)) == []
        assert time.perf_counter() - t0 < 5.0
        prid = svc.submit(ServeRequest(
            "predict", APP, configs=_rand_configs(sizes, 4, 0)))
        svc.result(prid, timeout=60.0)
        assert list(svc.stream(prid)) == []


def test_close_finishes_in_flight_dse(space):
    _, _, sizes = space
    svc = EvalService(coalesce=True)
    try:
        svc.register(APP, _proxy(space), sizes)
        rid = svc.submit(ServeRequest("dse", APP, sampler="nsga3",
                                      budget=96, seed=0,
                                      dse_kwargs={"pop": 12}))
    finally:
        svc.close()                    # races the running search
    resp = svc.result(rid, timeout=10.0)
    assert resp.ok, resp.error
    one_shot = dse_lib.SAMPLERS["nsga3"](
        sizes, as_engine(_proxy(space)), 96, seed=0, pop=12)
    assert resp.value.history == one_shot.history


def test_warm_start_serves_the_run_staged_engine(tmp_path):
    """A tenant warmed from the staged pipeline on a shared store serves
    the engine object `run_staged` memoized: predict rows on the front
    and a repeated DSE request bit-identical; label rows are the batched
    oracle's on the same device."""
    cfg = P.PipelineConfig(app=APP, n_samples=120, epochs=2,
                           dse_budget=100, hidden=32, n_layers=2,
                           dse_pop=16)
    store = ArtifactStore(str(tmp_path / "store"))
    res = P.run_staged(cfg, store, device="cpu")

    with EvalService(store) as svc:
        name = svc.warm_start(cfg, device="cpu")
        assert name in svc.tenants()
        assert svc._tenants[name].engine is res.engine
        pr = svc.result(svc.submit(ServeRequest(
            "predict", name, configs=res.pareto_configs)), timeout=300.0)
        dr = svc.result(svc.submit(ServeRequest(
            "dse", name, sampler=cfg.sampler, budget=cfg.dse_budget,
            seed=cfg.seed, dse_kwargs={"pop": cfg.dse_pop})),
            timeout=600.0)
        lr = svc.result(svc.submit(ServeRequest(
            "label", name, configs=res.pareto_configs[:4])), timeout=300.0)
        assert svc.warm_start(cfg, device="cpu") == name
    assert pr.ok, pr.error
    assert dr.ok, dr.error
    assert lr.ok, lr.error
    assert np.array_equal(pr.value, np.asarray(
        res.engine(res.pareto_configs)))
    assert dr.value.pareto_configs == res.pareto_configs
    assert np.array_equal(np.asarray(dr.value.pareto_objs),
                          np.asarray(res.pareto_objs))
    ctx = P.app_context(APP, device="cpu")
    want = tbo.objective_rows(ctx.app, ctx.entries, res.pareto_configs[:4],
                              ctx.inp, ctx.exact_out)
    assert np.array_equal(lr.value, want)
    assert store.stats.hits.get("dataset") and store.stats.hits.get("train")


def test_warm_start_tenant_split_over_devices_answers_as_one_device(
        tmp_path):
    """A tenant warmed with ``eval_devices=("cpu", "cpu")``: its engine
    (`stage_engine`) splits each chunk's configs over the two devices,
    and its dse, predict and label responses equal those of a tenant
    warmed on one device (each on its own store: the engine's store key
    leaves the devices out)."""
    base = P.PipelineConfig(app=APP, n_samples=120, epochs=2,
                            dse_budget=100, hidden=32, n_layers=2,
                            dse_pop=16, eval_chunk=32)
    out = {}
    for label, cfg in (("one", base), ("two", dataclasses.replace(
            base, eval_devices=("cpu", "cpu")))):
        with EvalService(ArtifactStore(str(tmp_path / label))) as svc:
            name = svc.warm_start(cfg, device="cpu")
            devices = svc._tenants[name].engine.devices
            dr = svc.result(svc.submit(ServeRequest(
                "dse", name, sampler=cfg.sampler, budget=cfg.dse_budget,
                seed=cfg.seed, dse_kwargs={"pop": cfg.dse_pop})),
                timeout=600.0)
            assert dr.ok, dr.error
            front = dr.value.pareto_configs
            pr = svc.result(svc.submit(ServeRequest(
                "predict", name, configs=front)), timeout=300.0)
            lr = svc.result(svc.submit(ServeRequest(
                "label", name, configs=front[:4])), timeout=300.0)
            assert pr.ok and lr.ok, (pr.error, lr.error)
            out[label] = (devices, dr.value, pr.value, lr.value)
    (d1, dse1, p1, l1), (d2, dse2, p2, l2) = out["one"], out["two"]
    assert d1 == 1 and d2 == 2
    assert dse2.pareto_configs == dse1.pareto_configs
    assert dse2.history == dse1.history
    assert np.array_equal(np.asarray(p2), np.asarray(p1))
    assert np.array_equal(np.asarray(l2), np.asarray(l1))


# --------------------------------------------------------------------------
# the service tests of tests/test_fault_dse.py on the port
# --------------------------------------------------------------------------

class _Gate:
    """Evaluator that blocks until released (a wedged backend)."""

    def __init__(self):
        self.release = threading.Event()

    def __call__(self, configs):
        self.release.wait(10.0)
        return _toy_eval(configs)


class _Sleepy:
    def __init__(self, dt):
        self.dt = dt

    def __call__(self, configs):
        time.sleep(self.dt)
        return _toy_eval(configs)


def test_submit_rejects_at_capacity_then_recovers():
    gate = _Gate()
    with EvalService(coalesce=False, max_inflight=1) as svc:
        svc.register("t", gate, SIZES)
        rid = svc.submit(ServeRequest("predict", "t", configs=[(0, 0, 0)]))
        with pytest.raises(ServiceOverloaded, match="capacity"):
            svc.submit(ServeRequest("predict", "t", configs=[(1, 0, 0)]))
        gate.release.set()
        assert svc.result(rid, timeout=10.0).ok
        rid2 = svc.submit(ServeRequest("predict", "t",
                                       configs=[(1, 0, 0)]))
        assert svc.result(rid2, timeout=10.0).ok   # capacity freed


def test_result_default_deadline_and_dead_handler_detection():
    gate = _Gate()
    with EvalService(coalesce=False, result_timeout_s=0.2) as svc:
        svc.register("t", gate, SIZES)
        rid = svc.submit(ServeRequest("predict", "t", configs=[(0, 0, 0)]))
        with pytest.raises(TimeoutError, match="result_timeout_s"):
            svc.result(rid)
        # a handler thread that died without responding is named
        dead = threading.Thread(target=lambda: None, name="dead-worker")
        dead.start()
        dead.join()
        svc._rec(rid).worker = dead
        with pytest.raises(RuntimeError, match="can never complete"):
            svc.result(rid, timeout=5.0)
        gate.release.set()


def test_service_health_snapshot():
    store = ArtifactStore(None)
    orphan = store.key("search_ckpt", {"run": "dead"})
    store.put(orphan, {"ck": 1})
    store._mtimes[orphan] -= 10.0
    with EvalService(store, coalesce=False, checkpoint_gc_age_s=5.0) as svc:
        svc.register("t", _toy_eval, SIZES)
        h = svc.health()
        assert h["ok"] and not h["closing"]
        assert "t" in h["tenants"]
        assert h["inflight"] == 0 and h["max_inflight"] == 256
        assert h["retries"] == {"t": 0} and h["quarantined"] == {"t": 0}
        assert h["checkpoint_gc"] == {"evicted_now": 1, "evicted_total": 1,
                                      "remaining": 0}
        assert not store.has(orphan)
    assert not svc.health()["ok"]              # closed


def test_dse_deadline_leaves_resumable_checkpoint():
    base = drain_steps(nsga_steps(SIZES, _toy_eval, 60, seed=5, pop=10))
    with EvalService(coalesce=False) as svc:
        svc.register("t", _Sleepy(0.03), SIZES)
        r = svc.result(svc.submit(ServeRequest(
            "dse", "t", budget=60, seed=5, dse_kwargs={"pop": 10},
            deadline_s=0.06, checkpoint_every=1)), timeout=30.0)
        assert not r.ok
        assert "deadline_s" in r.error and "resubmit" in r.error
        r2 = svc.result(svc.submit(ServeRequest(
            "dse", "t", budget=60, seed=5, dse_kwargs={"pop": 10},
            checkpoint_every=1)), timeout=60.0)
        assert r2.ok
        _assert_same_result(r2.value, base)


def test_dse_crash_resume_across_service_instances(tmp_path):
    """A dse request whose evaluator dies fails on service A; the same
    request to a new service on a new store over the same directory
    resumes from A's last checkpoint and matches the fault-free run."""
    store = ArtifactStore(str(tmp_path))
    base = drain_steps(nsga_steps(SIZES, _toy_eval, 80, seed=2, pop=10))
    req = dict(kind="dse", tenant="t", budget=80, seed=2,
               dse_kwargs={"pop": 10}, checkpoint_every=1)
    ck_key = store.key("search_ckpt", {
        "tenant": "t", "sampler": "nsga3", "budget": 80, "seed": 2,
        "kwargs": {"pop": 10}})

    calls = {"n": 0}

    def dying(configs):
        calls["n"] += 1
        if calls["n"] >= 5:               # permanent: fails every call on
            raise ValueError("host lost")
        return _toy_eval(configs)

    with EvalService(store=store, coalesce=False) as a:
        a.register("t", dying, SIZES)
        r = a.result(a.submit(ServeRequest(**req)), timeout=30.0)
        assert not r.ok and "host lost" in r.error
    assert store.has(ck_key)              # progress survived the crash

    store_b = ArtifactStore(str(tmp_path))
    with EvalService(store=store_b, coalesce=False) as b:
        b.register("t", _toy_eval, SIZES)
        r2 = b.result(b.submit(ServeRequest(**req)), timeout=60.0)
        assert r2.ok
        _assert_same_result(r2.value, base)
    assert not store_b.has(ck_key)        # evicted on completion


# --------------------------------------------------------------------------
# one request script, both packages' services
# --------------------------------------------------------------------------

def _script(sizes):
    """(kind, payload) per client: predicts, an nsga3 and an islands dse."""
    out = []
    for c in range(4):
        reqs = [("predict", _rand_configs(sizes, 16, 500 + 10 * c + r))
                for r in range(2)]
        reqs.append(("dse", "nsga3" if c % 2 else "islands", c))
        out.append(reqs)
    return out


def _serve_script(svc_mod, evaluate, sizes):
    """Send the script from 4 client threads; returns per client the
    responses and each dse request's streamed history."""
    script = _script(sizes)
    got = {}
    with svc_mod.EvalService(coalesce=True) as svc:
        svc.register(APP, evaluate, sizes)
        barrier = threading.Barrier(len(script))

        def client(c):
            barrier.wait()
            rids, streams = [], []
            for item in script[c]:
                if item[0] == "predict":
                    rids.append(svc.submit(svc_mod.ServeRequest(
                        "predict", APP, configs=item[1])))
                else:
                    kw = {"pop": 12} if item[1] == "nsga3" else \
                        {"pop": 6, "n_islands": 2}
                    rid = svc.submit(svc_mod.ServeRequest(
                        "dse", APP, sampler=item[1], budget=120,
                        seed=item[2], dse_kwargs=kw))
                    streams.append(list(svc.stream(rid)))
                    rids.append(rid)
            got[c] = (svc.results(rids, timeout=120.0), streams)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(len(script))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    return got


def test_same_script_same_responses_in_both_packages(space):
    """The reference's proxy evaluator behind both packages' services:
    predict rows, dse fronts and streamed histories bit-identical."""
    _, entries, sizes = space
    evaluate = jislands.library_proxy_evaluator(japps.APPS[APP], entries)
    want = _serve_script(jserve, evaluate, sizes)
    got = _serve_script(tserve, evaluate, sizes)
    assert sorted(got) == sorted(want)
    n_dse = 0
    for c in want:
        (wr, ws), (gr, gs) = want[c], got[c]
        assert gs == ws
        for a, b in zip(gr, wr):
            assert a.ok and b.ok, (a.error, b.error)
            assert a.kind == b.kind
            if a.kind == "predict":
                assert np.array_equal(a.value, b.value)
            else:
                n_dse += 1
                _assert_same_result(a.value, b.value)
    assert n_dse == 4


def test_port_service_uses_the_port_dse(space):
    """A dse request's result is the port's `DSEResult`."""
    _, _, sizes = space
    with EvalService(coalesce=True) as svc:
        svc.register(APP, _proxy(space), sizes)
        r = svc.result(svc.submit(ServeRequest(
            "dse", APP, budget=48, seed=0, dse_kwargs={"pop": 8})),
            timeout=60.0)
    assert r.ok and isinstance(r.value, dse_lib.DSEResult)


# --------------------------------------------------------------------------
# a config's row does not depend on the wave it came in
# --------------------------------------------------------------------------

def _rows_alone_and_in_a_wave(dev, hidden, n_layers):
    """Rows of 64 fresh configs from a fresh engine alone and as the
    first 64 of a 512-config call on another fresh engine, and the row
    counts the readouts ran at."""
    ctx = P.app_context("gaussian", device=dev)
    ds = tds.build("gaussian", n_samples=64, lib_entries=ctx.entries,
                   device=dev)
    cfg = tmodels.TwoStageConfig(gnn=tgnn.GNNConfig(
        arch="gsae", n_layers=n_layers, hidden=hidden,
        feature_dim=ds.x.shape[-1]))
    params = tmodels.init(torch.Generator(device=dev).manual_seed(0), cfg,
                          device=dev)
    pool = tds.sample_configs(ctx.app, 600, seed=9, lib_entries=ctx.entries)
    pool = [c for c in pool if c not in set(ds.configs)][:512]
    seen = []
    readout = tgnn.readout

    def recorded(c, p, h, m):
        seen.append(h.shape[0])
        return readout(c, p, h, m)

    def engine():
        return SurrogateEngine.from_gnn(cfg, params, ds, ctx.app,
                                        ctx.entries, chunk_size=512,
                                        device=dev)
    tgnn.readout = recorded
    try:
        alone = engine()(pool[:64])
        wave = engine()(pool)[:64]
    finally:
        tgnn.readout = readout
    return alone, wave, seen


def test_engine_rows_do_not_depend_on_the_wave():
    """The GNN engine's readouts run at the chunk's 512 rows whatever the
    call's size, so 64 configs alone give the rows they get inside a
    512-config wave, bit for bit."""
    alone, wave, seen = _rows_alone_and_in_a_wave("cpu", 32, 2)
    np.testing.assert_array_equal(alone, wave)
    # 4: `models.predict` on the construction check's probe batch
    assert set(seen) == {512, 4}


@pytest.mark.gpu
def test_engine_rows_do_not_depend_on_the_wave_on_the_card():
    """The same at the paper width on the card, where cuBLAS picks
    another algorithm for a 64-row graph-level head than for 512 rows
    (rows differed by up to 2.4e-4 before the readouts ran at one
    shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    alone, wave, _ = _rows_alone_and_in_a_wave(torch.device("cuda"), 300, 5)
    np.testing.assert_array_equal(alone, wave)
