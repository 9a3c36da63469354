"""The port engine's slice-5 side against the JAX package on the CPU: the
per-app views of the cross-app surrogate (`from_gnn_shared`) on carried
weights, the random-forest engine (`from_rforest`) on forests both
packages fit from one seed, the stats snapshot, and the queue and cache
API (`queued_view`, `abort_pending`, `reset_stats`, `clear_cache`,
`cache_size`), mirroring tests/test_engine.py."""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.accel import apps as japps
from repro.core import dataset as jds
from repro.core import gnn as jgnn
from repro.core import models as jmodels
from repro.core import pruning as jpruning
from repro.core import rforest as jrforest
from repro.core.engine import EngineStats as JStats
from repro.core.engine import SurrogateEngine as JEngine
from repro_torch.accel import apps as tapps
from repro_torch.core import dataset as tds
from repro_torch.core import gnn as tgnn
from repro_torch.core import graph as tgraph
from repro_torch.core import models as tmodels
from repro_torch.core import pruning as tpruning
from repro_torch.core import rforest as trforest
from repro_torch.core.engine import EngineStats, SurrogateEngine

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

APPS = ("sobel", "gaussian")
BUILD = dict(n_samples=16, seed=0, n_images=1, img_size=16,
             label_backend="loop")
N_LAYERS, HIDDEN = 2, 16


@pytest.fixture(scope="module")
def side():
    """Per app: (reference dataset, port dataset, reference entries, port
    entries); both merged sets."""
    jpr, tpr = jpruning.prune_library()[0], tpruning.prune_library()[0]
    per = {}
    for a in APPS:
        kinds = {n.kind for n in tapps.APPS[a].unit_nodes}
        jent, tent = {k: jpr[k] for k in kinds}, {k: tpr[k] for k in kinds}
        per[a] = (jds.build(a, lib_entries=jent, **BUILD),
                  tds.build(a, lib_entries=tent, device="cpu", **BUILD),
                  jent, tent)
    return (per, jds.merge({a: v[0] for a, v in per.items()}),
            tds.merge({a: v[1] for a, v in per.items()}))


def _fresh(a, per, n=16):
    jd, _, jent, _ = per[a]
    known = set(jd.configs)
    return [c for c in jds.sample_configs(tapps.APPS[a], 80, seed=9,
                                          lib_entries=jent)
            if c not in known][:n]


def _norm(y, ds):
    y = y.copy()
    y[:, 3] = 1 - y[:, 3]
    return (y - ds.y_mean) / ds.y_std


@pytest.mark.parametrize("app", APPS)
def test_shared_view_rows_match_the_reference(side, app):
    """`from_gnn_shared` on the reference's initial weights (gsae, 2
    layers, hidden 16, feature dim MERGED_FEATURE_DIM): rows normalized
    by each side's app stats allclose at atol 1e-4, denormalized at rtol
    1e-5 / atol 1e-5 (the bars of tests/test_torch_slice.py); the view's
    features of the app's dataset configs equal the merged rows (app
    block included), and its rows equal `models.predict` on them."""
    per, jm, tm = side
    cfg = dict(arch="gsae", n_layers=N_LAYERS, hidden=HIDDEN,
               feature_dim=tgraph.MERGED_FEATURE_DIM)
    jcfg = jmodels.TwoStageConfig(gnn=jgnn.GNNConfig(**cfg))
    tcfg = tmodels.TwoStageConfig(gnn=tgnn.GNNConfig(**cfg))
    jparams = jmodels.init(jax.random.PRNGKey(1), jcfg)
    tparams = tmodels.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    jd, td, jent, tent = per[app]
    jeng = JEngine.from_gnn_shared(jcfg, jparams, jm, app, jent,
                                   chunk_size=16)
    teng = SurrogateEngine.from_gnn_shared(tcfg, tparams, tm, app, tent,
                                           chunk_size=16, device="cpu")
    assert teng.backend == "torch-shared"
    fresh = _fresh(app, per)
    jy, ty = jeng(fresh), teng(fresh)
    assert ty.shape == (len(fresh), 4) and np.isfinite(ty).all()
    np.testing.assert_allclose(_norm(ty, td), _norm(jy, jd), atol=1e-4)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    # the same chunks; the port runs a ragged chunk as it is, where the
    # reference pads it to a power-of-two bucket for XLA
    assert teng.stats.chunks == jeng.stats.chunks
    assert teng.stats.padded == 0

    view = tm.view(app)
    X = teng.pipeline.prepare(view.configs)
    np.testing.assert_array_equal(X, view.x)
    with torch.no_grad():
        want = tmodels.predict(tcfg, tparams, *(torch.from_numpy(v) for v in
                                                (view.adj, X, view.mask)))[0]
    np.testing.assert_allclose(_norm(teng(view.configs), td), want.numpy(),
                               atol=1e-5)
    with pytest.raises(ValueError, match="not in merged"):
        SurrogateEngine.from_gnn_shared(tcfg, tparams, tm, "dct8", tent,
                                        device="cpu")
    # the view splits its chunks as from_gnn does: the same rows
    split = SurrogateEngine.from_gnn_shared(tcfg, tparams, tm, app, tent,
                                            chunk_size=16, devices=["cpu"] * 4,
                                            device="cpu")
    assert split.devices == 4
    np.testing.assert_array_equal(split(fresh), teng(fresh))


@pytest.mark.parametrize("app", APPS)
def test_rforest_rows_match_the_reference(side, app):
    """Forests fitted from the same seeds: on the same arrays the two
    packages' predictions are equal; each package's forest on its own
    dataset's flat features serves, through `from_rforest`, area, power
    and latency rows equal to the reference engine's and a 1 - SSIM
    column within 1e-6 (the SSIM labels, and so the stats that
    denormalize it, are float32 reductions in another order). A training
    config's row is the forest on its training feature row."""
    per, _, _ = side
    jd, td, jent, tent = per[app]
    Xf, yf = jd.flat_features(), jd.y
    for i in range(4):
        jf = jrforest.RandomForest(n_trees=4, seed=i).fit(Xf, yf[:, i])
        tf = trforest.RandomForest(n_trees=4, seed=i).fit(Xf, yf[:, i])
        np.testing.assert_array_equal(tf.predict(Xf), jf.predict(Xf))
    jtr, ttr = jd.split(0.9)[0], td.split(0.9)[0]
    jrf = {i: jrforest.RandomForest(n_trees=4, seed=i).fit(
        jtr.flat_features(), jtr.y[:, i]) for i in range(4)}
    trf = {i: trforest.RandomForest(n_trees=4, seed=i).fit(
        ttr.flat_features(), ttr.y[:, i]) for i in range(4)}
    fresh = _fresh(app, per)
    jy = JEngine.from_rforest(jrf, jd, japps.APPS[app], jent)(fresh)
    teng = SurrogateEngine.from_rforest(trf, td, tapps.APPS[app], tent,
                                        device="cpu")
    ty = teng(fresh)
    assert teng.backend == "rforest"
    np.testing.assert_array_equal(ty[:, :3], jy[:, :3])
    np.testing.assert_allclose(ty[:, 3], jy[:, 3], rtol=0, atol=1e-6)
    row = ttr.flat_features()[:1]
    want = np.stack([trf[i].predict(row) * td.y_std[i] + td.y_mean[i]
                     for i in range(4)], 1)
    want[:, 3] = 1 - want[:, 3]
    np.testing.assert_array_equal(teng([ttr.configs[0]]), want)


# --------------------------------------------------------------------------
# stats, queue and cache API on a cheap deterministic backend
# --------------------------------------------------------------------------

def _toy_rows(configs):
    a = np.asarray(configs, np.float64)
    return np.stack([a.sum(1), (a * a).sum(1), a.max(1)], 1)


class CountingBackend:
    def __init__(self):
        self.calls = []

    def __call__(self, configs):
        self.calls.append(len(configs))
        return _toy_rows(configs)


def _rand_configs(n, dims=5, card=9, seed=0):
    rng = np.random.default_rng(seed)
    return [tuple(int(v) for v in rng.integers(0, card, dims))
            for _ in range(n)]


def test_stats_snapshot_matches_the_reference():
    """`as_dict` has the reference's keys in its order, and the same
    values after the same calls on both engines (times aside); the
    derived rates follow their definitions."""
    assert list(EngineStats().as_dict()) == list(JStats().as_dict())
    snaps = []
    for Eng in (SurrogateEngine, JEngine):
        eng = Eng(CountingBackend(), chunk_size=16, fixed_shape=True)
        cfgs = _rand_configs(37, seed=5)
        eng(cfgs)
        eng(cfgs[:10])
        f = eng.submit(cfgs[3:5])
        eng.drain()
        f.result(timeout=5)
        snaps.append(eng.stats.as_dict())
    timed = {k for k in snaps[0] if k.endswith("_s") or k == "configs_per_sec"}
    assert {k: v for k, v in snaps[0].items() if k not in timed} == \
        {k: v for k, v in snaps[1].items() if k not in timed}
    s = EngineStats(configs=8, cache_hits=2, evaluated=6, padded=2,
                    wall_time_s=2.0, featurize_s=4.0, overlapped_s=1.0)
    assert (s.cache_hit_rate, s.configs_per_sec, s.padded_fraction,
            s.overlap_fraction) == (0.25, 4.0, 0.25, 0.25)
    assert EngineStats().as_dict()["padded_fraction"] == 0.0


def test_reset_stats_clear_cache_and_cache_size():
    be = CountingBackend()
    eng = SurrogateEngine(be, chunk_size=64)
    cfgs = _rand_configs(20, seed=4)
    y = eng(cfgs)
    assert eng.cache_size == len(set(cfgs))
    eng.reset_stats()
    assert eng.stats.calls == 0 and eng.stats.devices == 1
    np.testing.assert_array_equal(eng(cfgs), y)          # memo kept
    assert eng.stats.cache_hits == len(cfgs) and sum(be.calls) == len(
        set(cfgs))
    eng.clear_cache()
    assert eng.cache_size == 0
    eng(cfgs)
    assert sum(be.calls) == 2 * len(set(cfgs))
    off = SurrogateEngine(CountingBackend(), cache=False)
    off(cfgs)
    assert off.cache_size == 0


def test_abort_pending_fails_every_queued_submission():
    eng = SurrogateEngine(CountingBackend(), chunk_size=8)
    futs = [eng.submit(_rand_configs(3, seed=s)) for s in range(3)]
    assert eng.abort_pending(RuntimeError("tenant replaced")) == 3
    assert eng.pending() == 0 and eng.drain() == 0
    for f in futs:
        with pytest.raises(RuntimeError, match="tenant replaced"):
            f.result(timeout=5)
    f = eng.submit(_rand_configs(2))
    assert eng.abort_pending() == 1
    with pytest.raises(RuntimeError, match="aborted"):
        f.result(timeout=5)


def test_queued_views_batch_across_producers():
    """Producer threads querying through `queued_view` while one batcher
    drains: each gets the rows of its own configs, submissions fuse, and
    a view neither chunks nor pads."""
    eng = SurrogateEngine(CountingBackend(), chunk_size=256)
    stop = threading.Event()

    def batch_loop():
        while not stop.is_set():
            eng.drain(timeout=0.005)
        eng.drain(timeout=None)

    batcher = threading.Thread(target=batch_loop, daemon=True)
    batcher.start()
    n_threads, per_thread = 8, 20
    errs, views = [], []
    barrier = threading.Barrier(n_threads)

    def producer(t):
        view = eng.queued_view()
        views.append(view)
        try:
            barrier.wait()
            for i in range(per_thread):
                cfgs = _rand_configs(6, seed=31 * t + i)
                np.testing.assert_array_equal(view(cfgs), _toy_rows(cfgs))
        except Exception as e:             # reported below
            errs.append(e)

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    stop.set()
    batcher.join(timeout=10.0)
    assert not any(th.is_alive() for th in threads + [batcher])
    assert not errs, errs[0]
    assert eng.stats.submits == n_threads * per_thread
    assert 0 < eng.stats.drains <= eng.stats.submits
    assert eng.stats.batch_occupancy >= 1.0 and eng.pending() == 0
    v = views[0]
    assert v.backend == "queued:generic" and v.chunk_size is None
    assert v.stats.chunks == per_thread and v.stats.padded == 0
    with pytest.raises(ValueError, match="fixed_shape"):
        SurrogateEngine(CountingBackend(), chunk_size=None, fixed_shape=True)


def test_new_entry_points_need_a_card_or_the_cpu_named(side):
    """Without ``device=`` the slice's new entry points resolve to the CUDA
    card, and on a host without one they raise instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from repro_torch.accel import synth as tsynth
    per, _, tm = side
    _, td, _, tent = per["sobel"]
    app = tapps.APPS["sobel"]
    choice = {u.id: tent[u.kind][0] for u in app.unit_nodes}
    cfg = tmodels.TwoStageConfig(gnn=tgnn.GNNConfig(
        arch="gsae", n_layers=1, hidden=4,
        feature_dim=tgraph.MERGED_FEATURE_DIM))
    params = tmodels.init(torch.Generator().manual_seed(0), cfg, "cpu")
    for call in (lambda: tapps.probe_scalar(app, choice),
                 lambda: tsynth.static_timing(app, choice),
                 lambda: tds.build("sobel", n_samples=2, n_images=1,
                                   img_size=16, label_backend="loop"),
                 lambda: SurrogateEngine.from_gnn_shared(cfg, params, tm,
                                                         "sobel", tent),
                 lambda: SurrogateEngine.from_rforest({}, td, app, tent)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
