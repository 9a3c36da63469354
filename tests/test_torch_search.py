"""The port's search layer (`repro_torch.core.dse`, `repro_torch.core.
islands`) against the JAX package's on the CPU.

Both packages' searches are NumPy over one deterministic evaluator, so
everything they report must be equal to the bit: Pareto configs and
objective rows, the budget spent, the history (hypervolumes included),
the engine's counts, and a run resumed from a checkpoint. Both sides are
fed the reference's `library_proxy_evaluator` over the reference's
pruned sobel library (the port's library error metrics sit up to 4e-7
from the reference's, which could flip a front); the port's evaluator is held
against it in a test of its own. The island ranking's PyTorch backend is
held against NumPy and the reference's JAX kernel.
"""
import pickle

import numpy as np
import pytest
import torch

from repro.accel import apps as japps
from repro.core import dse as jdse
from repro.core import islands as jislands
from repro.core import pruning as jpruning
from repro_torch.accel import apps as tapps
from repro_torch.core import dse as tdse
from repro_torch.core import islands as tislands
from repro_torch.core import pruning as tpruning
from repro_torch.core.engine import SurrogateEngine

SPACE = [10] * 6


def _toy_eval(configs):
    a = np.asarray(configs, np.float64)
    return np.stack([a.sum(1), 9 * 6 - a.sum(1) + a.std(1), a.max(1)], 1)


@pytest.fixture(scope="module")
def pruned():
    """Both packages' pruned libraries."""
    return jpruning.prune_library()[0], tpruning.prune_library()[0]


@pytest.fixture(scope="module")
def proxy(pruned):
    """(sizes, the reference's proxy evaluator) for sobel."""
    app = japps.APPS["sobel"]
    jent = {k: pruned[0][k] for k in {n.kind for n in app.unit_nodes}}
    sizes = [len(jent[n.kind]) for n in app.unit_nodes]
    return sizes, jislands.library_proxy_evaluator(app, jent)


def _assert_same(a, b):
    """Two `DSEResult`s (either package) equal to the bit."""
    assert a.pareto_configs == b.pareto_configs
    np.testing.assert_array_equal(a.pareto_objs, b.pareto_objs)
    assert a.evaluated == b.evaluated
    assert a.history == b.history
    for k in ("calls", "configs", "cache_hits", "evaluated", "chunks"):
        assert a.stats[k] == b.stats[k], k


# per sampler: budget and keyword arguments (small, but every sampler
# runs several generations or batches)
RUNS = {
    "nsga3": (640, dict(pop=32)),
    "nsga2": (640, dict(pop=32)),
    "tpe": (320, dict(batch=32)),
    "random": (400, {}),
    "islands": (768, dict(n_islands=4, pop=16, epochs=4, migrate_k=2)),
    "islands_ref": (768, dict(n_islands=4, pop=16, epochs=4, migrate_k=2,
                              parallel=False)),
}


@pytest.mark.parametrize("sampler", sorted(RUNS))
def test_sampler_matches_the_reference(proxy, sampler):
    sizes, evaluate = proxy
    budget, kw = RUNS[sampler]
    a = tdse.SAMPLERS[sampler](sizes, evaluate, budget, seed=3, **kw)
    b = jdse.SAMPLERS[sampler](sizes, evaluate, budget, seed=3, **kw)
    assert len(a.pareto_configs) > 1 and len(a.history) >= 1
    _assert_same(a, b)


def test_warm_start_matches_the_reference(proxy):
    """An ``init`` population (the front of an earlier run) seeds nsga3,
    tpe and random the same way in both packages."""
    sizes, evaluate = proxy
    init = jdse.run_random(sizes, evaluate, 64, seed=1).pareto_configs
    for name, budget, kw in (("nsga3", 256, dict(pop=16)),
                             ("tpe", 128, dict(batch=16)),
                             ("random", 96, {})):
        _assert_same(tdse.SAMPLERS[name](sizes, evaluate, budget, seed=2,
                                         init=init, **kw),
                     jdse.SAMPLERS[name](sizes, evaluate, budget, seed=2,
                                         init=init, **kw))


@pytest.mark.parametrize("kw", [
    dict(n_islands=4, pop=8, epochs=4, migrate_k=4),
    dict(n_islands=4, pop=8, epochs=4, migrate_k=2, migration="ring"),
    dict(n_islands=3, pop=8, epochs=3, migrate_k=2,
         samplers=("nsga2",) * 3),
    dict(n_islands=4, pop=8, epochs=4, migrate_k=4, partition_refs=False),
    dict(n_islands=2, pop=5, epochs=3, migrate_k=2),      # odd pop
    dict(n_islands=4, pop=8, epochs=4, migrate_k=0),      # no migration
    dict(n_islands=4, pop=8, epochs=3, migrate_k=3,
         samplers=("nsga3", "nsga2", "tpe", "random")),   # scalar path
], ids=["broadcast", "ring", "nsga2", "no-cones", "odd-pop", "no-mig",
        "mixed"])
def test_islands_match_the_reference_on_the_toy_space(kw):
    """tests/test_islands_batched.py's cases: the port's batched fleet
    (ranked by its PyTorch backend on the CPU) against the reference's,
    and the port's scalar orchestrator against the reference's."""
    a = tislands.run_islands(SPACE, _toy_eval, 256, seed=3,
                             nds_backend="torch", device="cpu", **kw)
    b = jislands.run_islands(SPACE, _toy_eval, 256, seed=3, **kw)
    _assert_same(a, b)
    assert [e["islands"] for e in a.history] == \
        [e["islands"] for e in b.history]
    _assert_same(tislands.run_islands_ref(SPACE, _toy_eval, 256, seed=3,
                                          **kw),
                 jislands.run_islands_ref(SPACE, _toy_eval, 256, seed=3,
                                          **kw))


@pytest.mark.parametrize("sampler", ["nsga3", "nsga2", "islands"])
def test_checkpoint_resume_is_bit_identical(proxy, sampler):
    """Checkpoint every generation (epoch for islands), pickle the middle
    checkpoint as a store would, resume from it: the result equals the
    uninterrupted run's, which equals the reference's."""
    sizes, evaluate = proxy
    budget, kw = RUNS[sampler]
    kw = {k: v for k, v in kw.items() if k != "parallel"}
    saved = []
    full = tdse.drain_steps(tdse.iter_sampler(
        sampler, sizes, evaluate, budget, seed=5, checkpoint_every=1,
        checkpoint_sink=saved.append, **kw))
    assert len(saved) >= 3
    mid = pickle.loads(pickle.dumps(saved[len(saved) // 2]))
    assert isinstance(mid, tdse.SearchCheckpoint)
    resumed = tdse.drain_steps(tdse.iter_sampler(
        sampler, sizes, evaluate, budget, seed=5, resume_from=mid, **kw))
    assert resumed.pareto_configs == full.pareto_configs
    np.testing.assert_array_equal(resumed.pareto_objs, full.pareto_objs)
    assert resumed.history == full.history
    assert resumed.evaluated == full.evaluated
    _assert_same(full, jdse.drain_steps(jdse.iter_sampler(
        sampler, sizes, evaluate, budget, seed=5, **kw)))
    with pytest.raises(ValueError, match="does not match"):
        tdse.drain_steps(tdse.iter_sampler(
            sampler, sizes, evaluate, budget + 64, seed=5, resume_from=mid,
            **kw))


def test_iter_sampler_streams_the_history(proxy):
    """The yielded entries are the returned history's, for a stepping
    and a one-shot sampler; one-shot samplers refuse checkpoints."""
    sizes, evaluate = proxy
    for name, budget, kw in (("nsga3", 256, dict(pop=16)),
                             ("tpe", 96, dict(batch=16))):
        gen = tdse.iter_sampler(name, sizes, evaluate, budget, seed=1, **kw)
        seen = []
        while True:
            try:
                seen.append(next(gen))
            except StopIteration as e:
                res = e.value
                break
        assert seen == res.history and all(
            x is y for x, y in zip(seen, res.history))
    with pytest.raises(ValueError, match="cannot checkpoint"):
        tdse.drain_steps(tdse.iter_sampler("tpe", sizes, evaluate, 64,
                                           checkpoint_every=2))
    with pytest.raises(ValueError, match="unknown sampler"):
        tdse.iter_sampler("anneal", sizes, evaluate, 64)


def test_as_engine_wraps_in_the_ports_engine(proxy):
    _, evaluate = proxy
    eng = tdse.as_engine(evaluate)
    assert isinstance(eng, SurrogateEngine) and eng.backend == "wrapped"
    assert tdse.as_engine(eng) is eng


# --------------------------------------------------------------------------
# the proxy evaluator
# --------------------------------------------------------------------------

@pytest.mark.parametrize("app", ["sobel", "gaussian"])
def test_proxy_evaluator_matches_the_reference(pruned, app):
    """The port's evaluator over the port's library against the
    reference's over its own: area, power and latency equal (the same
    float64 arithmetic on equal PPA numbers), the error column within
    1e-6 relative: the two libraries' float32 error metrics (`mre`)
    differ by up to 4.2e-7 relative, a few float32 ulps, and
    ``1 - exp(-sum mre)`` moves by at most the sum's relative error."""
    jpr, tpr = pruned
    japp, tapp = japps.APPS[app], tapps.APPS[app]
    kinds = {n.kind for n in japp.unit_nodes}
    jent = {k: jpr[k] for k in kinds}
    tent = {k: tpr[k] for k in kinds}
    sizes = [len(jent[n.kind]) for n in japp.unit_nodes]
    rng = np.random.default_rng(0)
    cfgs = [tuple(int(rng.integers(0, s)) for s in sizes)
            for _ in range(256)]
    want = jislands.library_proxy_evaluator(japp, jent)(cfgs)
    got = tislands.library_proxy_evaluator(tapp, tent)(cfgs)
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=1e-6, atol=0)


# --------------------------------------------------------------------------
# the Pareto utilities and the fleet ranks
# --------------------------------------------------------------------------

def _instance(n, m, seed, scenario):
    rng = np.random.default_rng(seed)
    F = rng.random((n, m))
    if scenario == "duplicates":
        F[rng.integers(0, n, n // 2)] = F[rng.integers(0, n, n // 2)]
    elif scenario == "all_dominated":
        F[0] = 0.0
        F[1:] += 1.0
    elif scenario == "single_point":
        F = np.repeat(F[:1], n, 0)
    elif scenario == "discrete":
        F = np.round(F * 3) / 3
    return F


SCENARIOS = ("random", "duplicates", "all_dominated", "single_point",
             "discrete")


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_pareto_utilities_match_the_reference(scenario):
    """Sorting, ranks, masks (flat and blockwise), crowding, niching,
    hypervolume and Das-Dennis rays on adversarial instances: equal."""
    for seed in range(6):
        n, m = 5 + 9 * seed, 2 + seed % 3
        F = _instance(n, m, seed, scenario)
        for a, b in zip(tdse.non_dominated_sort(F),
                        jdse.non_dominated_sort(F)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tdse.non_dominated_ranks(F),
                                      jdse.non_dominated_ranks(F))
        np.testing.assert_array_equal(tdse.pareto_mask(F),
                                      jdse.pareto_mask(F))
        np.testing.assert_array_equal(tdse.pareto_mask_blockwise(F, 7),
                                      jdse.pareto_mask_blockwise(F, 7))
        np.testing.assert_array_equal(tdse.crowding_distance(F),
                                      jdse.crowding_distance(F))
        refs = tdse.das_dennis(m, 4)
        np.testing.assert_array_equal(refs, jdse.das_dennis(m, 4))
        np.testing.assert_array_equal(
            tdse._niche_select(F, n // 2, refs, np.random.default_rng(0)),
            jdse._niche_select(F, n // 2, refs, np.random.default_rng(0)))
        ref = tdse.hv_reference(F)
        np.testing.assert_array_equal(ref, jdse.hv_reference(F))
        assert tdse.hypervolume(F, ref) == jdse.hypervolume(F, ref)
        cfgs = [tuple(int(v) for v in row) for row in
                np.random.default_rng(seed).integers(0, 9, (n, 3))]
        pc, po = tdse.pareto_front(cfgs, F)
        qc, qo = jdse.pareto_front(cfgs, F)
        assert pc == qc
        np.testing.assert_array_equal(po, qo)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_fleet_ranks_torch_matches_numpy_and_jax(scenario):
    """The PyTorch front peeling on CPU tensors equals the NumPy ranks and
    the reference's JAX kernel, bit for bit, over a fleet of islands."""
    F = np.stack([_instance(48, 4, s, scenario) for s in range(5)])
    want = jislands.fleet_ranks(F, backend="numpy")
    np.testing.assert_array_equal(jislands.fleet_ranks(F, backend="jax"),
                                  want)
    got = tislands.fleet_ranks(F, backend="torch", device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tislands.fleet_ranks(F, backend="numpy"),
                                  want)


def test_fleet_ranks_auto_and_bad_backend(monkeypatch):
    """"auto" stays on NumPy with one device, as the reference does, and
    takes the PyTorch peeling where several CUDA devices are visible;
    an unknown backend raises."""
    F = _instance(30, 3, 0, "random")[None]
    want = tislands.fleet_ranks(F, backend="numpy")
    called = []
    real = tislands._ranks_kernel_torch
    monkeypatch.setattr(tislands, "_ranks_kernel_torch",
                        lambda R, devs: called.append(1) or real(R, devs))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    np.testing.assert_array_equal(tislands.fleet_ranks(F, device="cpu"),
                                  want)
    assert not called
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    np.testing.assert_array_equal(tislands.fleet_ranks(F, device="cpu"),
                                  want)
    assert called
    with pytest.raises(ValueError, match="nds_backend"):
        tislands.fleet_ranks(F, backend="jax")
    with pytest.raises(ValueError, match="nds_backend"):
        tislands.run_islands(SPACE, _toy_eval, 64, nds_backend="jax")


def test_islands_reject_bad_arguments():
    with pytest.raises(ValueError, match="migration"):
        tislands.run_islands(SPACE, _toy_eval, 64, migration="star")
    with pytest.raises(ValueError, match="n_islands"):
        tislands.run_islands(SPACE, _toy_eval, 64, n_islands=0)
    with pytest.raises(ValueError, match="unknown island sampler"):
        tislands.run_islands(SPACE, _toy_eval, 64, samplers=("anneal",))
    with pytest.raises(ValueError, match="cannot checkpoint"):
        tislands.run_islands(SPACE, _toy_eval, 64,
                             samplers=("nsga3", "tpe"), checkpoint_every=1)
    assert [f.name for f in tislands.IslandConfig.__dataclass_fields__
            .values()] == list(jislands.IslandConfig.__dataclass_fields__)


@pytest.mark.gpu
def test_fleet_ranks_on_the_card_equal_numpy():
    """On the card: the PyTorch peeling of pop-64 island stacks equals
    the NumPy ranks bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for scenario in SCENARIOS:
        F = np.stack([_instance(128, 4, s, scenario) for s in range(4)])
        np.testing.assert_array_equal(
            tislands.fleet_ranks(F, backend="torch", device="cuda"),
            tislands.fleet_ranks(F, backend="numpy"))
