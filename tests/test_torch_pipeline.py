"""The port's staged pipeline against the JAX package on the CPU.

Each stage is held where its inputs can be made equal:

* prune: the same entries, report and space;
* dataset: the bars of tests/test_torch_dataset.py (configs, crit,
  adjacency and masks equal; y_raw and x at rtol 1e-5);
* train: the stage's artifact equals a direct `fit_two_stage` and
  `evaluate` of the same config, bit for bit (the two packages' float32
  training drifts apart, tests/test_torch_training.py);
* engine: the reference's trained parameters, put into the port's store
  under the port's train key, served by the port's `stage_engine` within
  the reference engine's ``parity_atol=2e-3`` on normalized rows;
* search: both packages' `stage_search` over an engine wrapping the
  reference's `library_proxy_evaluator`, fronts and history bit for bit,
  also after a resume from a checkpoint;
* validate: the oracle rows on the reference's front, area, power and
  latency equal, 1 - SSIM within 1e-6 (the packages' SSIM labels differ
  by float32 summation order).

Then the rest of tests/test_pipeline_stages.py on the port alone. Sobel
and Gaussian at 150 samples, hidden 32, 3 layers, 3 epochs, budget 200.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import dse as jdse
from repro.core import islands as jislands
from repro.core import pipeline as jP
from repro.core.artifacts import ArtifactStore as JStore
from repro_torch.core import dse as tdse
from repro_torch.core import gnn as tgnn
from repro_torch.core import islands as tislands
from repro_torch.core import models as tmodels
from repro_torch.core import pipeline as P
from repro_torch.core import training as ttr
from repro_torch.core.artifacts import ArtifactStore
from repro_torch.core.engine import SurrogateEngine

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = "cpu"
APPS = ["sobel", "gaussian"]
SMALL = dict(n_samples=150, epochs=3, hidden=32, n_layers=3,
             dse_budget=200, dse_pop=16)
SAMPLERS = ["nsga3", "nsga2", "islands", "tpe", "random"]
DATA_EQUAL = ("adj", "mask", "unit_mask", "crit")
DATA_CLOSE = ("x", "y_raw")


def tiny_cfg(app="sobel", **kw):
    return P.PipelineConfig(app=app, **{**SMALL, **kw})


def ref_cfg(app="sobel", **kw):
    return jP.PipelineConfig(app=app, **{**SMALL, **kw})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's tiny tensors (several test
    workers share the cores); no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """app -> the reference's (cfg, store, ctx, dataset, train artifact,
    engine, front) through its own stages; the front is its search over
    its proxy evaluator."""
    out = {}
    store = JStore(None)
    for app in APPS:
        cfg = ref_cfg(app)
        ctx = jP.stage_prune(cfg, store)
        ds = jP.stage_dataset(cfg, store, ctx)
        art = jP.stage_train(cfg, store, ds)
        eng = jP.stage_engine(cfg, store, ctx, ds, art)
        front = jP.stage_search(cfg, store, ctx, jdse.as_engine(
            jislands.library_proxy_evaluator(ctx.app, ctx.entries)))
        out[app] = (cfg, store, ctx, ds, art, eng, front)
    return out


@pytest.fixture(scope="module")
def port():
    """app -> the port's (cfg, store, ctx, dataset) on the CPU."""
    out = {}
    store = ArtifactStore(None)
    for app in APPS:
        cfg = tiny_cfg(app)
        ctx = P.stage_prune(cfg, store, device=CPU)
        ds = P.stage_dataset(cfg, store, ctx, device=CPU)
        out[app] = (cfg, store, ctx, ds)
    return out


@pytest.fixture(scope="module")
def sobel_run():
    return P.run(tiny_cfg(), device=CPU)


def _configs(ctx, n, seed):
    rng = np.random.default_rng(seed)
    return [tuple(int(rng.integers(0, len(ctx.entries[u.kind])))
                  for u in ctx.app.unit_nodes) for _ in range(n)]


def _same_result(got, want):
    assert got.pareto_configs == want.pareto_configs
    np.testing.assert_array_equal(np.asarray(got.pareto_objs),
                                  np.asarray(want.pareto_objs))
    assert got.history == want.history        # full dicts, exact floats
    assert got.evaluated == want.evaluated


# --------------------------------------------------------------------------
# the configuration
# --------------------------------------------------------------------------

def test_config_fields_and_defaults_match_the_reference():
    """Every field and default of the reference's `PipelineConfig` but
    ``use_kernel`` (the tensor's device decides in the port), and the
    same paper-faithful configurations."""
    jf = {f.name: f.default for f in dataclasses.fields(jP.PipelineConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(P.PipelineConfig)}
    assert jf.pop("use_kernel") == "auto"
    assert tf == jf
    for app in ("sobel", "gaussian", "kmeans", "dct8", "fir15"):
        want = dataclasses.asdict(jP.PipelineConfig.paper_faithful(app))
        want.pop("use_kernel")
        assert dataclasses.asdict(P.PipelineConfig.paper_faithful(app)) \
            == want
    assert "use_kernel" not in P._engine_spec(tiny_cfg())


# --------------------------------------------------------------------------
# stage by stage against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("app", APPS)
def test_prune_matches_reference(ref, port, app):
    jctx, tctx = ref[app][2], port[app][2]
    assert set(tctx.entries) == set(jctx.entries)
    for k in jctx.entries:
        assert [e.inst.name for e in tctx.entries[k]] == \
            [e.inst.name for e in jctx.entries[k]]
    assert tctx.report == jctx.report
    assert tctx.space == jctx.space
    np.testing.assert_array_equal(tctx.inp.numpy(), np.asarray(jctx.inp))


@pytest.mark.parametrize("app", APPS)
def test_dataset_matches_reference(ref, port, app):
    jds, tds_ = ref[app][3], port[app][3]
    assert tds_.configs == jds.configs
    for k in DATA_EQUAL:
        np.testing.assert_array_equal(getattr(tds_, k), getattr(jds, k),
                                      err_msg=k)
    for k in DATA_CLOSE:
        np.testing.assert_allclose(getattr(tds_, k), getattr(jds, k),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("app", APPS)
def test_train_artifact_equals_a_direct_fit(port, app):
    """The stage's artifact is `fit_two_stage` + `evaluate` of the same
    config, bit for bit, its parameters as NumPy; a second call hits."""
    cfg, store, _, ds = port[app]
    art = P.stage_train(cfg, store, ds, device=CPU)
    tr, te = ds.split(0.9)
    tc = ttr.TrainConfig(epochs=cfg.epochs, seed=cfg.seed,
                         backend=cfg.train_backend,
                         patience=cfg.early_stop_patience)
    params = ttr.fit_two_stage(art.two_cfg, tr, tc, device=CPU)
    metrics = ttr.evaluate(art.two_cfg, params, ds, te, device=CPU)
    assert art.two_cfg.gnn == tgnn.GNNConfig(
        arch="gsae", n_layers=3, hidden=32, feature_dim=ds.x.shape[-1])
    assert art.metrics == metrics
    for a, b in zip(torch.utils._pytree.tree_leaves(art.params),
                    torch.utils._pytree.tree_leaves(params)):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b.numpy())
    assert P.stage_train(cfg, store, ds, device=CPU) is art


@pytest.mark.parametrize("app", APPS)
def test_engine_serves_the_reference_params(ref, port, app):
    """The reference's trained parameters under the port's train key:
    `stage_engine` serves rows within the reference engine's 2e-3 on
    normalized outputs, on 64 seeded configurations."""
    jcfg, jstore, jctx, jds, jart, jeng, _ = ref[app]
    cfg, _, tctx, tds_ = port[app]
    store = ArtifactStore(None)
    two_cfg = tmodels.TwoStageConfig(
        gnn=tgnn.GNNConfig(**dataclasses.asdict(jart.two_cfg.gnn)),
        use_critical_path=jart.two_cfg.use_critical_path,
        schema_version=jart.two_cfg.schema_version)
    carried = P.TrainArtifact(two_cfg, jart.metrics,
                              params=tmodels.TwoStageParams(*jart.params))
    store.put(store.key("train", P._train_spec(cfg)), carried)
    art = P.stage_train(cfg, store, tds_, device=CPU)
    assert art is carried and store.stats.hits == {"train": 1}
    eng = P.stage_engine(cfg, store, tctx, tds_, art, device=CPU)
    configs = _configs(tctx, 64, seed=5)
    got, want = eng(configs), np.asarray(jeng(configs))
    err = np.abs(got - want) / np.asarray(jds.y_std)
    assert err.max() <= 2e-3, err.max()
    assert P.stage_engine(cfg, store, tctx, tds_, art, device=CPU) is eng


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_search_matches_reference(ref, port, sampler):
    """Both packages' `stage_search` over the reference's proxy
    evaluator: the same front, rows and history, bit for bit."""
    jcfg, _, jctx = ref["sobel"][:3]
    cfg, _, tctx, _ = port["sobel"]
    proxy = jislands.library_proxy_evaluator(jctx.app, jctx.entries)
    want = jP.stage_search(dataclasses.replace(jcfg, sampler=sampler),
                           JStore(None), jctx, jdse.as_engine(proxy))
    got = P.stage_search(dataclasses.replace(cfg, sampler=sampler),
                         ArtifactStore(None), tctx, tdse.as_engine(proxy))
    _same_result(got, want)
    assert len(got.pareto_configs) > 0


@pytest.mark.parametrize("sampler", ["nsga3", "islands"])
def test_search_resumes_from_a_checkpoint(ref, port, tmp_path, sampler):
    """A checkpointed search killed after its first generation, resumed
    by `stage_search` on a new store over the same directory, equals the
    reference's uninterrupted run bit for bit; the checkpoint shares the
    plain run's key and is evicted once the result is cached."""
    jcfg, _, jctx = ref["sobel"][:3]
    cfg0, _, tctx, _ = port["sobel"]
    cfg = dataclasses.replace(cfg0, sampler=sampler, dse_checkpoint_every=1)
    plain = dataclasses.replace(cfg, dse_checkpoint_every=0)
    assert (ArtifactStore.key("search", P._search_spec(cfg))
            == ArtifactStore.key("search", P._search_spec(plain)))
    proxy = jislands.library_proxy_evaluator(jctx.app, jctx.entries)
    base = jP.stage_search(dataclasses.replace(jcfg, sampler=sampler),
                           JStore(None), jctx, jdse.as_engine(proxy))

    store = ArtifactStore(str(tmp_path))
    sizes = [len(tctx.entries[n.kind]) for n in tctx.app.unit_nodes]
    ck_key = store.key("search_ckpt", P._search_spec(cfg))
    sink = dict(checkpoint_every=1,
                checkpoint_sink=lambda ck: store.put(ck_key, ck))
    if sampler == "nsga3":
        gen = tdse.nsga_steps(sizes, tdse.as_engine(proxy), cfg.dse_budget,
                              seed=cfg.seed, pop=cfg.dse_pop, **sink)
    else:
        gen = tislands.islands_steps(
            sizes, tdse.as_engine(proxy), cfg.dse_budget, seed=cfg.seed,
            n_islands=cfg.dse_islands, migrate_k=cfg.dse_migrate_k,
            pop=max(2, cfg.dse_pop // cfg.dse_islands), **sink)
    next(gen)                                  # then the run is killed
    assert store.has(ck_key)

    resumed = ArtifactStore(str(tmp_path))     # a new process's store
    res = P.stage_search(cfg, resumed, tctx, tdse.as_engine(proxy))
    _same_result(res, base)
    assert not resumed.has(ck_key)
    assert resumed.stats.misses == {"search": 1}


@pytest.mark.parametrize("app", APPS)
def test_validate_pareto_matches_reference(ref, port, app):
    """On the reference's front: the oracle rows' area, power and latency
    equal and 1 - SSIM within 1e-6; `per_obj` equal for area, power and
    latency, and for 1 - SSIM within the bound 1e-6 in the truth moves
    it: |d rel_i| <= 1e-6 (1 + rel_i) / max(|t_i| - 1e-6, 1e-6), averaged
    (and over four columns for `mean_rel_err`)."""
    jcfg, jstore, jctx, jds, _, _, front = ref[app]
    cfg, _, tctx, tds_ = port[app]
    sel = front.pareto_configs[:10]
    assert len(sel) == 10
    want_rows = jP._oracle_eval(jctx.app, jctx.entries, jctx.inp,
                                jctx.exact_out)(sel)
    got_rows = P._oracle_eval(tctx.app, tctx.entries, tctx.inp,
                              tctx.exact_out)(sel)
    np.testing.assert_array_equal(got_rows[:, :3], want_rows[:, :3])
    np.testing.assert_allclose(got_rows[:, 3], want_rows[:, 3], rtol=0,
                               atol=1e-6)

    jres = jP.PipelineResult(jcfg, {}, {}, {}, front.pareto_configs,
                             front.pareto_objs, {}, jds, None)
    tres = P.PipelineResult(cfg, {}, {}, {}, front.pareto_configs,
                            np.asarray(front.pareto_objs), {}, tds_, None)
    want = jP.validate_pareto(jres, k=10, store=jstore)
    got = P.validate_pareto(tres, k=10, device=CPU)
    for n in ("area", "power", "latency"):
        assert got["per_obj"][n] == want["per_obj"][n], n
    pred = np.asarray(front.pareto_objs)[:10, 3]
    t = want_rows[:, 3]
    rel = np.abs(pred - t) / np.maximum(np.abs(t), 1e-6)
    bar = float(np.mean(1e-6 * (1 + rel)
                        / np.maximum(np.abs(t) - 1e-6, 1e-6)))
    assert abs(got["per_obj"]["1-ssim"] - want["per_obj"]["1-ssim"]) <= bar
    assert abs(got["mean_rel_err"] - want["mean_rel_err"]) <= bar / 4


# --------------------------------------------------------------------------
# staged path, caching and the surrogates (tests/test_pipeline_stages.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("app", APPS)
def test_staged_matches_run(app, sobel_run):
    cfg = tiny_cfg(app)
    one = sobel_run if app == "sobel" else P.run(cfg, device=CPU)
    store = ArtifactStore(None)
    ctx = P.stage_prune(cfg, store, device=CPU)
    ds = P.stage_dataset(cfg, store, ctx, device=CPU)
    art = P.stage_train(cfg, store, ds, device=CPU)
    engine = P.stage_engine(cfg, store, ctx, ds, art, device=CPU)
    res = P.stage_search(cfg, store, ctx, engine)
    assert res.pareto_configs == one.pareto_configs
    np.testing.assert_array_equal(res.pareto_objs, one.pareto_objs)
    for t in tmodels.TARGETS:
        assert art.metrics[t] == one.metrics[t]
    assert art.metrics["critical_path"] == one.metrics["critical_path"]
    assert one.metrics["engine"]["backend"] == "torch"
    assert one.metrics["dse_history"] == res.history


def test_second_run_hits_dataset_and_train_cache(tmp_path):
    cfg = tiny_cfg(artifact_dir=str(tmp_path))
    r1 = P.run(cfg, device=CPU)
    assert r1.metrics["store"]["hits"] == {}
    r2 = P.run(cfg, device=CPU)
    hits = r2.metrics["store"]["hits"]
    assert hits == {"dataset": 1, "train": 1, "search": 1}
    assert r2.pareto_configs == r1.pareto_configs
    np.testing.assert_array_equal(r2.pareto_objs, r1.pareto_objs)


def test_shared_store_sweep_reuses_dataset_and_train():
    """A DSE sweep (same surrogate, another budget) only re-searches."""
    store = ArtifactStore(None)
    P.run_staged(tiny_cfg(), store=store, device=CPU)
    r2 = P.run_staged(tiny_cfg(dse_budget=160), store=store, device=CPU)
    assert store.stats.hits.get("dataset") == 1
    assert store.stats.hits.get("train") == 1
    assert store.stats.misses.get("search") == 2
    assert r2.metrics["store"] == {
        "hits": {"prune": 1, "dataset": 1, "train": 1, "engine": 1},
        "misses": {"search": 1}}


def test_cached_params_round_trip_through_disk(tmp_path):
    """Params reloaded from the disk tier drive an engine to the same
    objective rows as the fresh in-memory fit."""
    cfg = tiny_cfg(artifact_dir=str(tmp_path))
    r1 = P.run(cfg, device=CPU)
    store = ArtifactStore(str(tmp_path))
    ctx = P.stage_prune(cfg, store, device=CPU)
    ds = P.stage_dataset(cfg, store, ctx, device=CPU)
    art = P.stage_train(cfg, store, ds, device=CPU)
    assert store.stats.hits.get("train") == 1
    assert all(isinstance(a, np.ndarray)
               for a in torch.utils._pytree.tree_leaves(art.params))
    engine = P.stage_engine(cfg, store, ctx, ds, art, device=CPU)
    assert engine is not r1.engine
    probe = r1.pareto_configs[:4]
    np.testing.assert_array_equal(engine(probe), r1.engine(probe))


def test_device_bound_keys():
    """The app context and the engine are memoized under keys that name
    the device; the disk keys do not."""
    store = ArtifactStore(None)
    cfg = tiny_cfg(dse_budget=60)
    res = P.run_staged(cfg, store=store, device=CPU)
    spec = P._engine_spec(cfg)
    assert store.get(store.key("engine", P._on(spec, torch.device(CPU)))) \
        is res.engine
    assert not store.has(store.key("engine", spec))
    assert not store.has(store.key("engine", P._on(spec, "cuda")))
    assert store.has(store.key("dataset", P._dataset_spec(cfg)))
    assert store.has(store.key("prune", P._on(P._prune_spec(cfg), CPU)))


def test_run_staged_oracle_and_rf_surrogates():
    store = ArtifactStore(None)
    # 30 samples: the NumPy forests' fit time grows with the rows
    r_rf = P.run_staged(tiny_cfg(surrogate="rf", dse_budget=60,
                                 n_samples=30), store=store, device=CPU)
    assert r_rf.engine.backend == "rforest"
    assert set(r_rf.metrics) >= set(tmodels.TARGETS)
    r_or = P.run_staged(tiny_cfg(surrogate="oracle", dse_budget=60,
                                 n_samples=40, epochs=1), store=store,
                        device=CPU)
    assert r_or.engine.backend == "oracle"
    assert len(r_or.pareto_configs) > 0


def test_ensemble_members_set_pareto_uncertainty():
    res = P.run_staged(tiny_cfg(ensemble_members=2, epochs=2,
                                dse_budget=60), device=CPU)
    assert res.engine.backend == "torch-ensemble"
    unc = res.metrics["pareto_uncertainty"]
    assert set(unc) == set(P.OBJ_NAMES)
    assert all(np.isfinite(v) and v >= 0 for v in unc.values())


def test_eval_devices_above_one_raise():
    """A count reads as at most that many local devices of the run's type
    (one CPU here), 0 as all of them; a negative count raises. A tuple of
    devices splits the engine's chunks (tests/test_torch_training_sharded
    .py holds its front to the unsplit run's)."""
    res = P.run_staged(tiny_cfg(eval_devices=2, dse_budget=60), device=CPU)
    assert res.engine.devices == 1
    with pytest.raises(ValueError, match="devices"):
        P.run_staged(tiny_cfg(eval_devices=-1, dse_budget=60), device=CPU)
    cpu = torch.device(CPU)
    assert P._eval_devices(tiny_cfg(eval_devices=0), cpu) == [cpu]
    assert P._eval_devices(tiny_cfg(eval_devices=("cpu",) * 3), cpu) == \
        [cpu] * 3


def test_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.run_staged(tiny_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.app_context("sobel")


# --------------------------------------------------------------------------
# validate_pareto
# --------------------------------------------------------------------------

def test_validate_pareto_oracle_engine_is_exact():
    """With the oracle surrogate the prediction is the ground truth."""
    cfg = tiny_cfg(surrogate="oracle", n_samples=40, epochs=1,
                   dse_budget=60)
    res = P.run(cfg, device=CPU)
    val = P.validate_pareto(res, k=5, device=CPU)
    assert val["mean_rel_err"] < 1e-6
    assert set(val["per_obj"]) == set(P.OBJ_NAMES)


def test_validate_pareto_gnn_engine_reports_finite_error(sobel_run):
    val = P.validate_pareto(sobel_run, k=5, device=CPU)
    assert np.isfinite(val["mean_rel_err"]) and val["mean_rel_err"] >= 0
    assert all(np.isfinite(v) for v in val["per_obj"].values())


def test_validate_pareto_empty_front_is_nan(sobel_run):
    res = dataclasses.replace(sobel_run, pareto_configs=[],
                              pareto_objs=np.zeros((0, 4)))
    assert np.isnan(P.validate_pareto(res, device=CPU)["mean_rel_err"])


def test_validate_pareto_reuses_store_context(sobel_run):
    store = ArtifactStore(None)
    P.app_context("sobel", sobel_run.cfg.theta, store, device=CPU)
    P.validate_pareto(sobel_run, k=3, store=store, device=CPU)
    assert store.stats.hits.get("prune") == 1


def test_pad_batch_empty_list_returns_empty_tensors():
    from repro.core import graph as jgraph
    from repro_torch.core import graph as tgraph
    for kw in ({}, {"feature_dim": 5}):
        got = tgraph.pad_batch([], [], n_pad=8, **kw)
        want = jgraph.pad_batch([], [], n_pad=8, **kw)
        assert [a.shape for a in got] == [a.shape for a in want]
    assert got[1].shape == (0, 8, 5)
    assert tgraph.pad_batch([], [], n_pad=8)[1].shape == \
        (0, 8, tgraph.FEATURE_DIM)


def test_pad_batch_mismatched_lengths_raise():
    from repro_torch.core import graph as tgraph
    with pytest.raises(ValueError, match="pad_batch"):
        tgraph.pad_batch([np.eye(2, dtype=np.float32)], [], n_pad=4)


def test_result_engine_field_and_predictor_alias(sobel_run):
    assert isinstance(sobel_run.engine, SurrogateEngine)
    assert sobel_run.predictor is sobel_run.engine


# --------------------------------------------------------------------------
# the unified surrogate
# --------------------------------------------------------------------------

def test_unified_surrogate_rejects_non_gnn_surrogates():
    with pytest.raises(ValueError, match="shared two-stage GNN"):
        P.unified_surrogate(["sobel"], P.PipelineConfig(surrogate="rf"),
                            device=CPU)
    with pytest.raises(ValueError, match="shared two-stage GNN"):
        P.unified_surrogate(["sobel"],
                            P.PipelineConfig(ensemble_members=4),
                            device=CPU)


def test_unified_surrogate_staged_caching(tmp_path):
    cfg = P.PipelineConfig(n_samples=100, epochs=2, hidden=32, n_layers=2,
                           artifact_dir=str(tmp_path))
    u1 = P.unified_surrogate(["sobel", "gaussian"], cfg, device=CPU)
    assert set(u1.engines) == {"sobel", "gaussian"}
    assert u1.engines["sobel"].backend == "torch-shared"
    store = ArtifactStore(str(tmp_path))
    u2 = P.unified_surrogate(["sobel", "gaussian"], cfg, store=store,
                             device=CPU)
    assert store.stats.hits.get("dataset") == 2
    assert store.stats.hits.get("train_unified") == 1
    # the cached params serve the same predictions
    ctx = P.app_context("sobel", device=CPU)
    probe = _configs(ctx, 3, seed=0)
    np.testing.assert_array_equal(u1.engines["sobel"](probe),
                                  u2.engines["sobel"](probe))
    # onboarding a third app reuses the two cached datasets
    store3 = ArtifactStore(str(tmp_path))
    P.unified_surrogate(["sobel", "gaussian", "fir15"], cfg, store=store3,
                        device=CPU)
    assert store3.stats.hits.get("dataset") == 2
    assert store3.stats.misses.get("dataset") == 1
    assert store3.stats.misses.get("train_unified") == 1
