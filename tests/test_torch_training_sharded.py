"""The port's splits of training and search over devices, on the CPU: one
CPU device named k times stands for k devices.

* `fit_ensemble(devices=...)` splits each architecture group's member
  axis: members bit-identical to the one-device fit (and so, through
  tests/test_torch_training.py, held to the reference's vmapped fit);
* `fit_two_stage` with ``TrainConfig(data_parallel=True)`` splits the
  sample axis and sums the gradients: within 1e-6 of the unsplit fit,
  the reference's own bar for its data-parallel run
  (tests/test_training.py), and from the reference's initial parameters
  and plan at tests/test_torch_training.py's bar of the reference's
  data-parallel fit;
* `fleet_ranks` and `run_islands` split the island axis: ranks, fronts
  and hypervolumes bit-identical to NumPy's and to the reference's;
* `run_staged` with ``eval_devices`` a tuple of devices: the front and
  history equal ``eval_devices=1``'s.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.core import dse as jdse
from repro.core import gnn as jgnn
from repro.core import islands as jislands
from repro.core import models as jmodels
from repro.core import training as jtr
from repro_torch.accel import apps as tapps
from repro_torch.core import dataset as tds
from repro_torch.core import dse as tdse
from repro_torch.core import gnn as tgnn
from repro_torch.core import islands as tislands
from repro_torch.core import models as tmodels
from repro_torch.core import pipeline as P
from repro_torch.core import pruning as tpruning
from repro_torch.core import training as ttr
from repro_torch.core.artifacts import ArtifactStore
from test_torch_search import SPACE, _instance, _toy_eval
from test_torch_training import (_as_reference, _assert_fit_close,
                                 _max_diff, _np_params, _reference_plan)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = torch.device("cpu")
TC = dict(epochs=3, batch_size=16, seed=0)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the tiny tensors (several test workers
    share the cores); no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sobel():
    """(port dataset, its 86-row and 87-row training splits)."""
    pruned = tpruning.prune_library()[0]
    app = tapps.APPS["sobel"]
    entries = {k: pruned[k] for k in {n.kind for n in app.unit_nodes}}
    out = {}
    for n in (96, 97):
        td = tds.build("sobel", n_samples=n, seed=0, lib_entries=entries,
                       device="cpu")
        out[n] = (td, td.split(0.9)[0])
    assert out[96][1].y.shape[0] == 86 and out[97][1].y.shape[0] == 87
    return out


def _cfg(ds, dropout=0.0, arch="gsae", use_cp=True):
    return tmodels.TwoStageConfig(gnn=tgnn.GNNConfig(
        arch=arch, n_layers=2, hidden=24, feature_dim=ds.x.shape[-1],
        dropout=dropout), use_critical_path=use_cp)


# --------------------------------------------------------------------------
# the member split
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_ensemble_members_bit_identical_over_devices(sobel, dropout):
    """4 gsae members over 2 devices (2 slices of 2) and over 3 (whose
    prefix that divides 4 is 2); a mixed ensemble of 4 gsae and 4 gcn
    members over 2 devices: parameters and per-step losses equal the
    one-device fit's bit for bit, dropout on and off."""
    _, tr = sobel[97]
    cfg = _cfg(tr, dropout)
    tc = ttr.TrainConfig(**TC)
    one, h1 = ttr.fit_ensemble(cfg, tr, tc, n_members=4, device="cpu")
    for k in (2, 3):
        got, hk = ttr.fit_ensemble(cfg, tr, tc, n_members=4, device="cpu",
                                   devices=[CPU] * k)
        assert _max_diff(got.groups[0][1], one.groups[0][1]) == 0
        np.testing.assert_array_equal(hk["train_loss"], h1["train_loss"])
        np.testing.assert_array_equal(hk["epochs_run"], h1["epochs_run"])
    archs = ["gsae", "gcn"] * 4
    one, h1 = ttr.fit_ensemble(cfg, tr, tc, n_members=8, archs=archs,
                               device="cpu")
    got, hk = ttr.fit_ensemble(cfg, tr, tc, n_members=8, archs=archs,
                               device="cpu", devices=[CPU] * 2)
    assert got.member_arch == one.member_arch
    for (_, a), (_, b) in zip(got.groups, one.groups):
        assert _max_diff(a, b) == 0
    np.testing.assert_array_equal(hk["train_loss"], h1["train_loss"])


def test_one_member_slices_equal_single_fits(sobel):
    """Over as many devices as members each slice holds one member. Its
    step runs at a member batch of one, whose reductions round in another
    order than a batch of several on the CPU; such a slice equals the
    single fit with the member's seed, bit for bit, as the stacked
    members equal it at float32 rounding."""
    _, tr = sobel[97]
    cfg = _cfg(tr, 0.2)
    tc = ttr.TrainConfig(**TC)
    got, hk = ttr.fit_ensemble(cfg, tr, tc, n_members=3, device="cpu",
                               devices=[CPU] * 3)
    stacked, _ = ttr.fit_ensemble(cfg, tr, tc, n_members=3, device="cpu")
    for m in range(3):
        single, hs = ttr.fit_two_stage(
            cfg, tr, dataclasses.replace(tc, seed=m), return_history=True,
            device="cpu")
        member = pytree.tree_map(lambda a: a[m], got.groups[0][1])
        assert _max_diff(member, single) == 0
        np.testing.assert_array_equal(hk["train_loss"][m], hs.train_loss)
        assert _max_diff(pytree.tree_map(lambda a: a[m],
                                         stacked.groups[0][1]),
                         single) <= 1e-6


def test_ensemble_split_with_early_stopping(sobel):
    """Each member stops on its own; a slice stops when its members have:
    the snapshots and the NaN tails equal the one-device run's."""
    _, tr = sobel[96]
    cfg = _cfg(tr)
    tc = ttr.TrainConfig(epochs=8, batch_size=16, seed=2, patience=1,
                         val_frac=0.2, lr=5e-2)
    one, h1 = ttr.fit_ensemble(cfg, tr, tc, n_members=4, device="cpu")
    got, hk = ttr.fit_ensemble(cfg, tr, tc, n_members=4, device="cpu",
                               devices=[CPU] * 2)
    assert _max_diff(got.groups[0][1], one.groups[0][1]) == 0
    np.testing.assert_array_equal(hk["train_loss"], h1["train_loss"])
    np.testing.assert_array_equal(hk["epochs_run"], h1["epochs_run"])
    assert (h1["epochs_run"] < tc.epochs).any()


# --------------------------------------------------------------------------
# data parallelism
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,dropout,use_cp", [
    (96, 2, 0.0, True), (97, 3, 0.0, True), (96, 2, 0.25, True),
    (96, 4, 0.0, False)])
def test_data_parallel_fit_within_the_reference_bar(sobel, n, k, dropout,
                                                    use_cp):
    """86 rows over 2 devices (43 each), 87 over 3, 86 over 4 (whose
    prefix that divides 86 is 2): every parameter within 1e-6 of the
    unsplit fit, per-step losses within 1e-6."""
    _, tr = sobel[n]
    cfg = _cfg(tr, dropout, use_cp=use_cp)
    tc = ttr.TrainConfig(**TC, data_parallel=True)
    a, ha = ttr.fit_two_stage(cfg, tr, ttr.TrainConfig(**TC),
                              return_history=True, device="cpu")
    b, hb = ttr.fit_two_stage(cfg, tr, tc, return_history=True,
                              device="cpu", devices=[CPU] * k)
    assert _max_diff(a, b) <= 1e-6
    np.testing.assert_allclose(hb.train_loss, ha.train_loss, rtol=0,
                               atol=1e-6)
    # the split really ran: another summation order shows in the bits
    if k in (2, 3):
        assert _max_diff(a, b) > 0


def test_data_parallel_on_one_device_or_no_divisor_is_the_plain_fit(sobel):
    """devices=1, and 87 rows over 2 devices (no prefix of more than one
    divides 87), run the unsplit loop: bit-identical."""
    _, tr = sobel[97]
    cfg = _cfg(tr)
    a = ttr.fit_two_stage(cfg, tr, ttr.TrainConfig(**TC), device="cpu")
    for devices in (1, [CPU] * 2):
        b = ttr.fit_two_stage(cfg, tr, ttr.TrainConfig(**TC,
                                                       data_parallel=True),
                              device="cpu", devices=devices)
        assert _max_diff(a, b) == 0


def test_data_parallel_against_the_reference_data_parallel_run(sobel):
    """The reference's `fit_two_stage(data_parallel=True)` and the port's
    loop split over 2 devices from the reference's params0 along its
    `_plan_for` plan: per-step losses at atol 1e-5, parameters at
    tests/test_torch_training.py's bar."""
    _, tr = sobel[96]
    jd = _as_reference(tr, "sobel")
    g = dict(arch="gsae", n_layers=2, hidden=24, feature_dim=tr.x.shape[-1],
             dropout=0.0)
    jc = jmodels.TwoStageConfig(gnn=jgnn.GNNConfig(**g))
    tc = tmodels.TwoStageConfig(gnn=tgnn.GNNConfig(**g))
    jtc = jtr.TrainConfig(**TC, data_parallel=True)
    ttc = ttr.TrainConfig(**TC, data_parallel=True)
    jp, jh = jtr.fit_two_stage(jc, jd, jtc, return_history=True)
    p0 = tmodels.params_from_numpy(
        _np_params(jmodels.init(jax.random.PRNGKey(TC["seed"]), jc)), CPU)
    idx, w = _reference_plan(jtc, 86, 16)
    tp, (trl, _, act) = ttr._fit(tc, ttc, ttr._as_data(tr, CPU), p0, idx,
                                 w, None, devices=[CPU] * 2)
    assert act.all()
    np.testing.assert_allclose(trl, jh.train_loss, atol=1e-5, rtol=0)
    _assert_fit_close(jp, tp, ttc.lr)


def test_split_losses_add_up_to_the_whole_batch(sobel):
    """`models.losses` over the whole minibatch's divisors: the parts'
    losses and gradients sum to the whole batch's."""
    _, tr = sobel[96]
    cfg = _cfg(tr)
    params = tmodels.init(torch.Generator().manual_seed(4), cfg,
                          device="cpu")
    data = ttr._as_data(tr, CPU)
    rows = torch.tensor([3, 50, 7, 80, 0, 0])
    w = torch.tensor([1.0, 1, 1, 1, 1, 0])
    batch = {k: v[rows] for k, v in data.items()}
    batch["w"] = w
    whole, _ = tmodels.losses(cfg, params, batch)
    um = (data["unit_mask"][rows] * w[:, None]).sum()
    denoms = (w.sum(), um)
    parts = []
    for sel in ([0, 2, 4, 5], [1, 3]):
        b = {k: v[sel] for k, v in batch.items()}
        parts.append(tmodels.losses(cfg, params, b, denoms=denoms)[0])
    torch.testing.assert_close(parts[0] + parts[1], whole, rtol=1e-6,
                               atol=1e-7)


# --------------------------------------------------------------------------
# the island axis
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_islands", [8, 4, 5, 1])
def test_fleet_ranks_over_8_devices_bit_identical_to_numpy(n_islands):
    """8 islands one a device, 4 on the first four, 5 (no prefix of more
    than one divides it but 5 itself), 1: the ranks equal NumPy's and the
    reference's, whatever the split."""
    F = np.stack([_instance(30, 4, s, sc) for s, sc in zip(
        range(n_islands), ["random", "duplicates", "all_dominated",
                           "random", "duplicates", "random", "random",
                           "random"])])
    want = tislands.fleet_ranks(F, backend="numpy")
    np.testing.assert_array_equal(want, jislands.fleet_ranks(F, "numpy"))
    for backend in ("torch", "auto"):
        got = tislands.fleet_ranks(F, backend=backend, devices=[CPU] * 8)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)


def test_fleet_ranks_auto_takes_the_split_when_devices_are_given(
        monkeypatch):
    F = _instance(30, 3, 0, "random")[None]
    called = []
    real = tislands._peel
    monkeypatch.setattr(tislands, "_peel",
                        lambda s: called.append(len(s)) or real(s))
    tislands.fleet_ranks(F, devices=[CPU])
    assert not called                           # one device: NumPy
    tislands.fleet_ranks(np.concatenate([F, F]), devices=[CPU] * 2)
    assert called == [2]


@pytest.mark.parametrize("n_islands", [4, 8])
def test_run_islands_over_8_devices_matches_numpy_and_the_reference(
        n_islands):
    """The fleet over 8 devices: front and hypervolume trajectory
    bit-identical to the NumPy backend's and to the reference's run
    (tests/test_islands_batched.py's acceptance, in process)."""
    kw = dict(seed=0, n_islands=n_islands, pop=8, epochs=4, migrate_k=4)
    split = tislands.run_islands(SPACE, _toy_eval, 256, nds_backend="torch",
                                 devices=[CPU] * 8, **kw)
    local = tislands.run_islands(SPACE, _toy_eval, 256, nds_backend="numpy",
                                 **kw)
    ref = jislands.run_islands(SPACE, _toy_eval, 256, nds_backend="numpy",
                               **kw)
    for other in (local, ref):
        assert [list(map(int, c)) for c in split.pareto_configs] == \
            [list(map(int, c)) for c in other.pareto_configs]
        assert [e["hypervolume"] for e in split.history] == \
            [e["hypervolume"] for e in other.history]
        np.testing.assert_array_equal(split.pareto_objs, other.pareto_objs)
    assert jdse.pareto_mask(split.pareto_objs).all()
    assert tdse.pareto_mask(split.pareto_objs).all()


# --------------------------------------------------------------------------
# the staged pipeline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sampler,ensemble", [("nsga3", 0), ("islands", 0),
                                              ("nsga3", 2)])
def test_run_staged_eval_devices_equal_one_device(sampler, ensemble):
    """A small sobel run with the engine split over two devices named by
    string: front, objectives and history equal ``eval_devices=1``'s; the
    engine reports the cap, the store's engine key leaves it out."""
    base = P.PipelineConfig(app="sobel", n_samples=150, epochs=3, hidden=32,
                            n_layers=3, dse_budget=200, dse_pop=16,
                            sampler=sampler, ensemble_members=ensemble,
                            eval_chunk=64)
    one = P.run_staged(base, ArtifactStore(), device="cpu")
    cfg = dataclasses.replace(base, eval_devices=("cpu", "cpu"))
    two = P.run_staged(cfg, ArtifactStore(), device="cpu")
    assert one.engine.devices == 1 and two.engine.devices == 2
    assert two.metrics["engine"]["devices"] == 2
    assert two.pareto_configs == one.pareto_configs
    np.testing.assert_array_equal(two.pareto_objs, one.pareto_objs)
    assert two.metrics["dse_history"] == one.metrics["dse_history"]
    assert P._engine_spec(cfg) == P._engine_spec(base)
    assert P._eval_devices(dataclasses.replace(base, eval_devices=0),
                           CPU) == [CPU]
