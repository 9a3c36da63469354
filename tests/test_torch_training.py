"""The port's training slice against the JAX package on the CPU: the
two-stage losses, their gradients and Adam on carried parameters; the fit
on the reference's initial parameters and batch plan; early stopping;
dropout; ensembles; evaluation; the ensemble engine.

Both packages see the same arrays: the sobel dataset (97 samples, as in
tests/test_training.py) is labeled once by the port and handed to the
reference as its own `AccelDataset`. The models are gsae or gcn with 2
layers of 24. TF32 is off.

Tolerances. float32 forward and backward passes in two libraries agree
to a few ulps (losses 1e-6, gradients 1e-6 of gradients up to 0.2). Adam
then divides each first moment by the root of the second, so an element
whose gradient sits at rounding noise (a ReLU at its kink) can step by
up to the learning rate on one side and not the other: the fit's
parameters are held at ``lr`` on every element and 1e-5 on 99% of them,
its per-step losses at 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.accel import apps as japps
from repro.core import dataset as jds
from repro.core import gnn as jgnn
from repro.core import graph as jgraph
from repro.core import models as jmodels
from repro.core import training as jtr
from repro.core.engine import SurrogateEngine as JEngine
from repro_torch.accel import apps as tapps
from repro_torch.core import dataset as tds
from repro_torch.core import gnn as tgnn
from repro_torch.core import graph as tgraph
from repro_torch.core import models as tmodels
from repro_torch.core import pruning as tpruning
from repro_torch.core import training as ttr
from repro_torch.core.engine import SurrogateEngine

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = torch.device("cpu")
TC = dict(epochs=3, batch_size=16, seed=0)
KEYS = ("adj", "x", "mask", "unit_mask", "y", "crit")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for each test's tiny tensors: with the default
    (a thread per core) in each of several test workers, the threads of
    every small op contend for the cores and a step that takes a
    millisecond alone takes a hundred. The pin is for the training
    steps' speed only: no result here depends on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _as_reference(td, app):
    """The reference's `AccelDataset` over the port's arrays."""
    kw = {f.name: getattr(td, f.name) for f in dataclasses.fields(td)
          if f.name != "graph"}
    return jds.AccelDataset(graph=jgraph.build_graph(japps.APPS[app]),
                            **kw)


@pytest.fixture(scope="module")
def sobel():
    """(port entries, port dataset, the reference's view of it)."""
    pruned = tpruning.prune_library()[0]
    app = tapps.APPS["sobel"]
    entries = {k: pruned[k] for k in {n.kind for n in app.unit_nodes}}
    # 97 samples -> 87 train: 87 % 16 != 0 exercises the padded tail
    td = tds.build("sobel", n_samples=97, seed=0, lib_entries=entries,
                   device="cpu")
    return entries, td, _as_reference(td, "sobel")


def _cfgs(ds, dropout=0.0, arch="gsae", use_cp=True, feature_dim=None):
    g = dict(arch=arch, n_layers=2, hidden=24,
             feature_dim=feature_dim or ds.x.shape[-1], dropout=dropout)
    return (jmodels.TwoStageConfig(gnn=jgnn.GNNConfig(**g),
                                   use_critical_path=use_cp),
            tmodels.TwoStageConfig(gnn=tgnn.GNNConfig(**g),
                                   use_critical_path=use_cp))


def _named(tree, prefix=""):
    """{path: numpy leaf}: one naming for both packages' trees (JAX
    flattens dicts by sorted key, torch by insertion)."""
    if hasattr(tree, "_fields"):
        tree = {k: getattr(tree, k) for k in tree._fields}
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _named(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _named(v, f"{prefix}{i}.").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    return {prefix: np.asarray(tree)}


def _max_diff(a, b):
    a, b = _named(a), _named(b)
    assert sorted(a) == sorted(b)
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def _assert_fit_close(jp, tp, lr):
    """Every element within ``lr`` (one Adam step's reach), 99% of them
    within 1e-5."""
    a, b = _named(jp), _named(tp)
    d = np.concatenate([np.abs(a[k] - b[k]).ravel() for k in a])
    assert d.max() <= lr, d.max()
    assert np.quantile(d, 0.99) <= 1e-5, np.quantile(d, 0.99)


def _np_params(jparams):
    return jax.tree.map(np.asarray, jparams)


def _batch(ds, rows, w=None):
    b = {k: np.asarray(getattr(ds, k))[rows] for k in KEYS}
    if w is not None:
        b["w"] = np.asarray(w, np.float32)
    return b


# --------------------------------------------------------------------------
# losses, gradients, Adam
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "weighted", "no_critical_path"])
def test_losses_and_gradients_match(sobel, case):
    """`models.losses` and its gradients on carried parameters and one
    batch: total and both parts at atol 1e-6, every gradient leaf at
    atol 1e-6. "weighted" pads the batch with three weight-0 rows, which
    must leave the loss as it was."""
    _, td, jd = sobel
    jc, tc = _cfgs(td, use_cp=case != "no_critical_path")
    jp = _np_params(jmodels.init(jax.random.PRNGKey(0), jc))
    tp = tmodels.params_from_numpy(jp, CPU)
    rows = np.arange(16)
    w = None
    if case == "weighted":
        rows = np.concatenate([np.arange(13), [0, 1, 2]])
        w = [1.0] * 13 + [0.0] * 3
    b = _batch(jd, rows, w)
    (jl, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodels.losses(jc, p, {k: jnp.asarray(v) for k, v in
                                         b.items()}), has_aux=True))(jp)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tl, tparts = tmodels.losses(tc, tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-6, rtol=0)
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   atol=1e-6, rtol=0)
    loss, tg = ttr.loss_and_grads(tc, tp, tb)
    assert float(loss) == float(tl)
    assert _max_diff(jg, tg) <= 1e-6
    if case == "weighted":
        l13, _ = tmodels.losses(tc, tp, {k: v[:13] for k, v in tb.items()
                                         if k != "w"})
        np.testing.assert_allclose(float(tl), float(l13), rtol=1e-6)


def test_adam_steps_match(sobel):
    """Three Adam steps fed the same gradients: the port's `_foreach`
    update against `repro.core.training._adam_update` at atol 1e-7."""
    _, td, _ = sobel
    jc, _ = _cfgs(td)
    jp = _np_params(jmodels.init(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32) * 10.0 ** rng.integers(-6, 1), jp) for _ in range(3)]
    js, ts = jtr._adam_init(jp), None
    tp = tmodels.params_from_numpy(jp, CPU)
    ts = ttr._adam_init(tp)
    update = jax.jit(jtr._adam_update)
    for g in grads:
        jp, js = update(jp, g, js, 1e-3)
        tp, ts = ttr._adam_update(tp, tmodels.params_from_numpy(g, CPU), ts,
                                  1e-3)
    assert _max_diff(jp, tp) <= 1e-7
    assert ts["t"] == int(js["t"]) == 3


# --------------------------------------------------------------------------
# the fit
# --------------------------------------------------------------------------

def _reference_plan(jtc, n, bs):
    idx, w, _ = jtr._plan_for(jtc, n, bs)
    return (torch.from_numpy(np.array(idx)).long(),
            torch.from_numpy(np.array(w)))


def test_fit_on_the_reference_plan_matches(sobel):
    """Dropout 0, 3 epochs, a padded tail: the port's loop from the
    reference's params0 along the reference's `_plan_for` plan. Per-step
    losses at atol 1e-5; parameters as in the module docstring."""
    _, td, jd = sobel
    jtrn, _ = jd.split(0.9)
    ttrn, _ = td.split(0.9)
    assert ttrn.y.shape[0] % 16 != 0
    jc, tc = _cfgs(td)
    jtc, ttc = jtr.TrainConfig(**TC), ttr.TrainConfig(**TC)
    jp, jh = jtr.fit_two_stage(jc, jtrn, jtc, return_history=True)
    p0 = tmodels.params_from_numpy(
        _np_params(jmodels.init(jax.random.PRNGKey(TC["seed"]), jc)), CPU)
    idx, w = _reference_plan(jtc, ttrn.y.shape[0], 16)
    tp, (tr, vls, act) = ttr._fit(tc, ttc, ttr._as_data(ttrn, CPU), p0,
                                  idx, w, None)
    assert tr.shape == jh.train_loss.shape and act.all()
    np.testing.assert_allclose(tr, jh.train_loss, atol=1e-5, rtol=0)
    _assert_fit_close(jp, tp, ttc.lr)
    # p0 is the caller's: the loop trains a copy
    assert _max_diff(p0, tmodels.params_from_numpy(_np_params(
        jmodels.init(jax.random.PRNGKey(TC["seed"]), jc)), CPU)) == 0


def test_early_stopping_matches_the_reference(sobel):
    """lr 5e-2 makes the validation loss bounce (the reference's own
    test): the same epochs_run and the same best epoch, validation
    losses up to the best epoch at rtol 2e-3, and the returned snapshot
    scores the best recorded validation loss. At this learning rate
    Adam's steps on noise-level gradients reach 5e-2 (the two
    trajectories drift apart by ~1e-4 of the loss an epoch), so the
    parameters are not compared element by element."""
    _, td, jd = sobel
    jtrn, _ = jd.split(0.9)
    ttrn, _ = td.split(0.9)
    jc, tc = _cfgs(td)
    kw = dict(epochs=10, batch_size=16, seed=1, patience=2, val_frac=0.2,
              lr=5e-2)
    jp, jh = jtr.fit_two_stage(jc, jtrn, jtr.TrainConfig(**kw),
                               return_history=True)
    ttc = ttr.TrainConfig(**kw)
    tr2, va2 = ttr._split_for_val(ttc, ttrn, None)
    idx, w = _reference_plan(jtr.TrainConfig(**kw), tr2.y.shape[0], 16)
    p0 = tmodels.params_from_numpy(
        _np_params(jmodels.init(jax.random.PRNGKey(1), jc)), CPU)
    val = ttr._as_data(va2, CPU)
    tp, (tr, vls, act) = ttr._fit(tc, ttc, ttr._as_data(tr2, CPU), p0,
                                  idx, w, None, val)
    assert int(act.sum()) == jh.epochs_run < kw["epochs"]
    best = int(np.nanargmin(jh.val_loss[:jh.epochs_run]))
    assert int(np.nanargmin(vls)) == best
    np.testing.assert_allclose(vls[:best + 1], jh.val_loss[:best + 1],
                               rtol=2e-3)
    assert np.isnan(tr[jh.epochs_run:]).all()
    got = float(tmodels.losses(tc, tp, val)[0])
    np.testing.assert_allclose(got, float(np.nanmin(vls)), rtol=1e-5)
    # the public entry point (its own plan) carves the same split and
    # returns its best snapshot
    tp2, h2 = ttr.fit_two_stage(tc, ttrn, ttc, return_history=True,
                                device="cpu")
    assert h2.val_loss is not None and np.isfinite(
        h2.val_loss[:h2.epochs_run]).all()
    np.testing.assert_allclose(
        float(tmodels.losses(tc, tp2, val)[0]),
        float(np.nanmin(h2.val_loss)), rtol=1e-5)


def test_backend_names_run_the_one_loop(sobel):
    """"scan" and "loop" are the same loop; any other name raises."""
    _, td, _ = sobel
    ttrn, _ = td.split(0.9)
    _, tc = _cfgs(td, dropout=0.25)
    a, ha = ttr.fit_two_stage(tc, ttrn, ttr.TrainConfig(**TC),
                              return_history=True, device="cpu")
    b, hb = ttr.fit_two_stage(tc, ttrn, ttr.TrainConfig(**TC, backend="loop"),
                              return_history=True, device="cpu")
    assert _max_diff(a, b) == 0
    np.testing.assert_array_equal(ha.train_loss, hb.train_loss)
    assert ha.val_loss is None and ha.epochs_run == TC["epochs"]
    with pytest.raises(ValueError, match="backend"):
        ttr.fit_two_stage(tc, ttrn, ttr.TrainConfig(**TC, backend="pmap"),
                          device="cpu")


def test_data_parallel_is_a_noop_on_one_device(sobel):
    _, td, _ = sobel
    ttrn, _ = td.split(0.9)
    _, tc = _cfgs(td)
    a = ttr.fit_two_stage(tc, ttrn, ttr.TrainConfig(**TC), device="cpu")
    b = ttr.fit_two_stage(tc, ttrn, ttr.TrainConfig(**TC, data_parallel=True),
                          device="cpu")
    assert _max_diff(a, b) == 0


def test_plan_covers_every_sample_each_epoch():
    """The port's own plan (a CPU generator seeded ``seed + 1``): each
    epoch a permutation of the rows, the tail padded at weight 0, the
    same plan on every call."""
    tc = ttr.TrainConfig(epochs=2, batch_size=16, seed=4)
    idx, w = ttr._plan_for(tc, 87, 16)
    assert tuple(idx.shape) == tuple(w.shape) == (2, 6, 16)
    for ep in range(2):
        real = idx[ep].ravel()[w[ep].ravel() > 0]
        assert sorted(real.tolist()) == list(range(87))
    assert float(w.sum()) == 2 * 87
    idx2, w2 = ttr._plan_for(tc, 87, 16)
    assert torch.equal(idx, idx2) and torch.equal(w, w2)


def test_warm_start_from_numpy_leaves(sobel):
    """``params0`` with NumPy leaves is re-deviced and trained on; zero
    epochs of training return it as it was."""
    _, td, _ = sobel
    ttrn, _ = td.split(0.9)
    jc, tc = _cfgs(td)
    jp = _np_params(jmodels.init(jax.random.PRNGKey(3), jc))
    p = ttr.fit_two_stage(tc, ttrn, ttr.TrainConfig(epochs=0), device="cpu",
                          params0=jp)
    assert _max_diff(jp, p) == 0


# --------------------------------------------------------------------------
# dropout and evaluation
# --------------------------------------------------------------------------

def test_dropout_changes_training_and_inference_is_deterministic(sobel):
    """With dropout the masks reach both stages (losses and parameters
    move); `models.predict` and `evaluate` stay bit-identical between
    calls."""
    _, td, _ = sobel
    ttrn, tte = td.split(0.9)
    tc0, tc3 = _cfgs(td, 0.0)[1], _cfgs(td, 0.3)[1]
    cfg = ttr.TrainConfig(**TC)
    p0, h0 = ttr.fit_two_stage(tc0, ttrn, cfg, return_history=True,
                               device="cpu")
    p1, h1 = ttr.fit_two_stage(tc3, ttrn, cfg, return_history=True,
                               device="cpu")
    assert np.abs(h0.train_loss - h1.train_loss).max() > 1e-4
    assert _max_diff(p0, p1) > 1e-6
    b = {k: torch.from_numpy(np.asarray(getattr(ttrn, k))[:8]) for k in KEYS}
    keep_a = tmodels.draw_keep(tc3, torch.Generator().manual_seed(1), 8,
                               b["x"].shape[1])
    keep_b = tmodels.draw_keep(tc3, torch.Generator().manual_seed(2), 8,
                               b["x"].shape[1])
    l0 = float(tmodels.losses(tc3, p1, b)[0])
    la = float(tmodels.losses(tc3, p1, b, keep=keep_a)[0])
    lb = float(tmodels.losses(tc3, p1, b, keep=keep_b)[0])
    assert abs(la - l0) > 1e-6 and abs(la - lb) > 1e-6
    args = [torch.from_numpy(getattr(tte, k)) for k in ("adj", "x", "mask")]
    y1, c1 = tmodels.predict(tc3, p1, *args)
    y2, c2 = tmodels.predict(tc3, p1, *args)
    assert torch.equal(y1, y2) and torch.equal(c1, c2)
    assert ttr.evaluate(tc3, p1, td, tte, device="cpu") == \
        ttr.evaluate(tc3, p1, td, tte, device="cpu")


def test_held_out_r2_in_a_band_around_the_reference(sobel):
    """Dropout 0.1, 20 epochs, seeds 0-2 on each side (each package draws
    its own init, plan and masks; member m of an ensemble is the single
    fit with seed m): the mean held-out R2 per target over the seeds
    within 0.2 of the reference's. 30 held-out rows of a 97-sample set:
    one seed's R2 moves by up to ~0.3 (the reference's own spread)."""
    _, td, jd = sobel
    jtrn, jte = jd.split(0.7)
    ttrn, tte = td.split(0.7)
    jc, tc = _cfgs(td, 0.1)
    kw = dict(epochs=20, batch_size=16, seed=0)
    jens, _ = jtr.fit_ensemble(jc, jtrn, jtr.TrainConfig(**kw), n_members=3)
    tens, _ = ttr.fit_ensemble(tc, ttrn, ttr.TrainConfig(**kw), n_members=3,
                               device="cpu")
    ref = [jtr.evaluate(jc, jax.tree.map(lambda a: a[m], jens.groups[0][1]),
                        jd, jte) for m in range(3)]
    port = [ttr.evaluate(tc, pytree.tree_map(lambda a: a[m],
                                             tens.groups[0][1]),
                         td, tte, device="cpu") for m in range(3)]
    ref = np.asarray([[r[t]["r2"] for t in jmodels.TARGETS] for r in ref])
    port = np.asarray([[r[t]["r2"] for t in jmodels.TARGETS] for r in port])
    print("held-out R2 per seed (rows) and target: reference", ref.round(3),
          "port", port.round(3))
    assert np.abs(port.mean(0) - ref.mean(0)).max() <= 0.2, (ref, port)


def test_evaluate_matches_the_reference_on_carried_params(sobel):
    """`evaluate` on the reference's parameters: R2 and MAPE per target
    at atol 1e-5 (float32 predictions 1e-6 apart), crit accuracy
    equal."""
    _, td, jd = sobel
    _, jte = jd.split(0.7)
    _, tte = td.split(0.7)
    jc, tc = _cfgs(td)
    jp = jtr.fit_two_stage(jc, jd.split(0.7)[0], jtr.TrainConfig(**TC))
    jm = jtr.evaluate(jc, jp, jd, jte)
    tm = ttr.evaluate(tc, _np_params(jp), td, tte, device="cpu")
    assert set(jm) == set(tm)
    for t in jmodels.TARGETS:
        for k in ("r2", "mape"):
            np.testing.assert_allclose(tm[t][k], jm[t][k], atol=1e-5)
    assert tm["critical_path"] == jm["critical_path"]


# --------------------------------------------------------------------------
# ensembles
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_ensemble_deterministic_and_member_parity(sobel, dropout):
    """Two runs identical; member m within 1e-5 of a single fit with seed
    ``tc.seed + m`` (the reference's bar, tests/test_training.py), with
    dropout too: each member's masks come from its own generator,
    outside the vmapped step."""
    _, td, _ = sobel
    ttrn, tte = td.split(0.9)
    _, tc = _cfgs(td, dropout)
    cfg = ttr.TrainConfig(**TC)
    ens_a, hist_a = ttr.fit_ensemble(tc, ttrn, cfg, n_members=3, device="cpu")
    ens_b, hist_b = ttr.fit_ensemble(tc, ttrn, cfg, n_members=3, device="cpu")
    assert _max_diff(ens_a.groups[0][1], ens_b.groups[0][1]) == 0
    np.testing.assert_array_equal(hist_a["train_loss"], hist_b["train_loss"])
    assert hist_a["train_loss"].shape == (3, TC["epochs"], 6)
    assert hist_a["epochs_run"].tolist() == [TC["epochs"]] * 3
    for m in range(3):
        p_m, h_m = ttr.fit_two_stage(
            tc, ttrn, dataclasses.replace(cfg, seed=TC["seed"] + m),
            return_history=True, device="cpu")
        member = pytree.tree_map(lambda a: a[m], ens_a.groups[0][1])
        assert _max_diff(member, p_m) <= 1e-5
        np.testing.assert_allclose(hist_a["train_loss"][m], h_m.train_loss,
                                   atol=1e-5)
    mean, std, Y = ttr.ensemble_predict(ens_a, tte.adj, tte.x, tte.mask,
                                        device="cpu")
    assert Y.shape[0] == 3 and mean.shape == std.shape == (len(tte.y), 4)
    assert bool((std >= 0).all()) and float(std.max()) > 0


def _reference_ensemble(jc, archs, n_per_arch=2):
    groups = []
    for g, arch in enumerate(archs):
        g_cfg = dataclasses.replace(jc, gnn=dataclasses.replace(jc.gnn,
                                                                arch=arch))
        keys = jnp.stack([jax.random.PRNGKey(10 * g + m)
                          for m in range(n_per_arch)])
        groups.append((g_cfg, jax.vmap(lambda k, c=g_cfg: jmodels.init(
            k, c))(keys)))
    return jtr.EnsembleParams(groups=groups, member_arch=[
        a for a in archs for _ in range(n_per_arch)])


def _as_port_ensemble(jens, tc):
    return ttr.EnsembleParams(groups=[
        (dataclasses.replace(tc, gnn=dataclasses.replace(
            tc.gnn, arch=g_cfg.gnn.arch)),
         tmodels.params_from_numpy(_np_params(p), CPU))
        for g_cfg, p in jens.groups], member_arch=list(jens.member_arch))


def test_ensemble_predict_and_evaluate_match_the_reference(sobel):
    """A two-arch ensemble (gsae and gcn, two members each) on carried
    stacked parameters: mean, std and every member's rows at atol 1e-5;
    `evaluate_ensemble` R2, MAPE and mean std at atol 1e-4, crit accuracy
    equal."""
    _, td, jd = sobel
    _, jte = jd.split(0.8)
    _, tte = td.split(0.8)
    jc, tc = _cfgs(td)
    jens = _reference_ensemble(jc, ("gsae", "gcn"))
    tens = _as_port_ensemble(jens, tc)
    assert tens.n_members == jens.n_members == 4
    jm, js, jY = jtr.ensemble_predict(jens, jte.adj, jte.x, jte.mask)
    tm, ts, tY = ttr.ensemble_predict(tens, tte.adj, tte.x, tte.mask,
                                      device="cpu")
    for a, b in ((jm, tm), (js, ts), (jY, tY)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    je = jtr.evaluate_ensemble(jens, jd, jte)
    te = ttr.evaluate_ensemble(tens, td, tte, device="cpu")
    for t in jmodels.TARGETS:
        for k in ("r2", "mape", "mean_std"):
            np.testing.assert_allclose(te[t][k], je[t][k], atol=1e-4)
    assert te["critical_path"] == je["critical_path"]


def test_multi_arch_ensemble(sobel):
    _, td, _ = sobel
    ttrn, tte = td.split(0.9)
    _, tc = _cfgs(td)
    ens, hist = ttr.fit_ensemble(tc, ttrn, ttr.TrainConfig(**TC),
                                 n_members=4,
                                 archs=("gsae", "gcn", "gsae", "gcn"),
                                 device="cpu")
    assert [g[0].gnn.arch for g in ens.groups] == ["gsae", "gcn"]
    assert ens.member_arch == ["gsae", "gsae", "gcn", "gcn"]
    assert hist["train_loss"].shape[0] == 4
    _, _, Y = ttr.ensemble_predict(ens, tte.adj, tte.x, tte.mask,
                                   device="cpu")
    assert Y.shape[0] == 4
    m = ttr.evaluate_ensemble(ens, td, tte, device="cpu")
    assert set(tmodels.TARGETS) <= set(m)
    assert all("mean_std" in m[t] for t in tmodels.TARGETS)
    with pytest.raises(ValueError):
        ttr.fit_ensemble(tc, ttrn, ttr.TrainConfig(**TC), n_members=3,
                         archs=("gsae",), device="cpu")


# --------------------------------------------------------------------------
# the merged dataset: evaluate_merged, fit_unified, evaluate_transfer
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def merged(sobel):
    """sobel and gaussian merged by the port, with the reference's view
    of the same arrays."""
    pruned = tpruning.prune_library()[0]
    app = tapps.APPS["gaussian"]
    entries = {k: pruned[k] for k in {n.kind for n in app.unit_nodes}}
    gd = tds.build("gaussian", n_samples=40, seed=0, lib_entries=entries,
                   n_images=1, img_size=16, device="cpu")
    per = {"sobel": sobel[1], "gaussian": gd}
    tm = tds.merge(per)
    kw = {f.name: getattr(tm, f.name) for f in dataclasses.fields(tm)}
    kw["per_app"] = {a: _as_reference(d, a) for a, d in per.items()}
    return per, tm, jds.MergedDataset(**kw)


def test_evaluate_merged_matches_the_reference(merged):
    """On carried parameters over the merged feature layout: the whole
    set and sobel's view, R2 and MAPE at atol 1e-5, crit accuracy
    equal."""
    _, tm, jm = merged
    jc, tc = _cfgs(tm, feature_dim=tgraph.MERGED_FEATURE_DIM)
    jp = jmodels.init(jax.random.PRNGKey(5), jc)
    for jv, tv in [(jm, tm), (jm.view("sobel"), tm.view("sobel"))]:
        je = jtr.evaluate_merged(jc, jp, jv)
        te = ttr.evaluate_merged(tc, _np_params(jp), tv, device="cpu")
        for t in jmodels.TARGETS:
            for k in ("r2", "mape"):
                np.testing.assert_allclose(te[t][k], je[t][k], atol=1e-5)
        assert te["critical_path"] == je["critical_path"]


def test_fit_unified_and_transfer(merged):
    """The unified fit and the leave-one-out transfer report what the
    reference's do (keys, per-app breakdown), with finite metrics; a
    wrong feature dim and an unknown holdout raise."""
    per, _, _ = merged
    _, tc = _cfgs(per["sobel"], feature_dim=tgraph.MERGED_FEATURE_DIM)
    cfg = ttr.TrainConfig(epochs=2, batch_size=16)
    params, mds, metrics = ttr.fit_unified(per, tc, cfg, device="cpu")
    assert set(metrics["per_app"]) <= set(mds.app_names)
    assert all(np.isfinite(metrics[t]["r2"]) for t in tmodels.TARGETS)
    out = ttr.evaluate_transfer(per, "gaussian", tc, cfg, finetune_epochs=1,
                                device="cpu")
    assert out["holdout"] == "gaussian" and out["shared_apps"] == ["sobel"]
    assert set(out) == {"holdout", "shared_apps", "shared_metrics",
                        "zero_shot", "fine_tuned", "finetune_epochs"}
    assert all(np.isfinite(out[k][t]["mape"]) for k in ("zero_shot",
                                                        "fine_tuned")
               for t in tmodels.TARGETS)
    with pytest.raises(ValueError, match="feature_dim"):
        ttr.fit_unified(per, _cfgs(per["sobel"])[1], cfg, device="cpu")
    with pytest.raises(ValueError, match="holdout"):
        ttr.evaluate_transfer(per, "dct8", tc, cfg, device="cpu")


# --------------------------------------------------------------------------
# the ensemble engine
# --------------------------------------------------------------------------

def test_engine_ensemble_uncertainty(sobel):
    """As tests/test_training.py::test_engine_ensemble_uncertainty, and
    the rows against the reference engine serving the same parameters
    at rtol/atol 1e-4 (each side featurizes with its own featurizer,
    1e-6 apart)."""
    entries, td, jd = sobel
    ttrn, _ = td.split(0.9)
    _, tc = _cfgs(td)
    ens, _ = ttr.fit_ensemble(tc, ttrn, ttr.TrainConfig(**TC), n_members=3,
                              device="cpu")
    app = tapps.APPS["sobel"]
    eng = SurrogateEngine.from_gnn_ensemble(ens, td, app, entries,
                                            chunk_size=32, device="cpu")
    assert eng.backend == "torch-ensemble" and eng.obj_cols == 4
    cfgs = [tuple(int(v) for v in c) for c in ttrn.configs[:12]]
    rows = eng(cfgs)
    assert rows.shape == (12, 4)
    unc = eng.uncertainty(cfgs)
    assert unc.shape == (12, 4) and bool((unc >= -1e-9).all())
    assert eng.stats.cache_hits >= 12
    mr, sr = eng.predict_with_uncertainty(cfgs)
    np.testing.assert_allclose(mr, rows)
    np.testing.assert_allclose(sr, unc)
    A, X, M = tds.features_for_configs(td, app, entries, cfgs, device="cpu")
    mean, std, _ = ttr.ensemble_predict(ens, A, X, M, device="cpu")
    want = td.denorm_y(mean.numpy())
    want[:, 3] = 1 - want[:, 3]
    np.testing.assert_allclose(rows, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(unc, std.numpy() * td.y_std, rtol=1e-4,
                               atol=1e-6)
    # the reference engine on the same members
    jc, _ = _cfgs(td)
    jens = jtr.EnsembleParams(groups=[(jc, jax.tree.map(
        lambda a: jnp.asarray(a.numpy()), ens.groups[0][1]))],
        member_arch=ens.member_arch)
    # the reference featurizes from the port's library entries (sobel's
    # rows from the reference's own entries are the same to the bit)
    jeng = JEngine.from_gnn_ensemble(jens, jd, japps.APPS["sobel"], entries,
                                     chunk_size=32)
    jm, js = jeng.predict_with_uncertainty(cfgs)
    np.testing.assert_allclose(mr, jm, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sr, js, rtol=1e-4, atol=1e-6)
    # empty submissions carry the objective width
    assert eng.submit([]).result().shape == (0, 4)


def test_engine_without_ensemble_rejects_uncertainty():
    eng = SurrogateEngine(lambda cs: np.zeros((len(cs), 4)))
    with pytest.raises(ValueError):
        eng.uncertainty([(0, 0)])
    with pytest.raises(ValueError):
        eng.predict_with_uncertainty([(0, 0)])


def test_train_config_and_history_fields_match_the_reference():
    """The configs carry across: the same field names and defaults."""
    for j, t in ((jtr.TrainConfig, ttr.TrainConfig),
                 (jtr.FitHistory, ttr.FitHistory),
                 (jtr.EnsembleParams, ttr.EnsembleParams)):
        jf = [(f.name, f.default) for f in dataclasses.fields(j)]
        tf = [(f.name, f.default) for f in dataclasses.fields(t)]
        assert jf == tf
    assert ttr.TrainConfig.paper_faithful() == ttr.TrainConfig(
        **dataclasses.asdict(jtr.TrainConfig.paper_faithful()))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_first_step_on_the_card_matches_the_cpu(sobel):
    """The first step's loss and every gradient leaf on the card against
    the CPU plain path, from the same parameters and batch, dropout 0, in
    float64: the loss and each leaf to 1e-12 of the leaf's largest entry.
    (In float32 a pre-activation within rounding of a ReLU's kink flips
    on one side and moves a leaf by up to ~1e-3 of its largest entry.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, td, _ = sobel
    _, tc = _cfgs(td)
    p = pytree.tree_map(lambda a: a.double(), tmodels.init(
        torch.Generator().manual_seed(0), tc, device="cpu"))
    b = {k: torch.from_numpy(v).double()
         for k, v in _batch(td, np.arange(16)).items()}
    lc, gc = ttr.loss_and_grads(tc, p, b)
    dev = torch.device("cuda")
    ld, gd = ttr.loss_and_grads(
        tc, pytree.tree_map(lambda a: a.to(dev), p),
        {k: v.to(dev) for k, v in b.items()})
    np.testing.assert_allclose(float(ld), float(lc), rtol=1e-12)
    a, c = _named(gd), _named(gc)
    for k in a:
        assert np.abs(a[k] - c[k]).max() <= 1e-12 * np.abs(c[k]).max(), k
