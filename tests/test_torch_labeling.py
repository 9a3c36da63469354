"""The scalar labeling path of the port against the JAX package, for all
five accelerators on the CPU: `apps.accuracy_ssim`, `apps.probe_scalar`,
`synth.static_timing`, `batch_oracle.crit_sets` and
`dataset.build(label_backend="loop")`, on the same NumPy-made images and
configurations on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.accel import apps as japps
from repro.accel import batch_oracle as jbo
from repro.accel import synth as jsynth
from repro.core import dataset as jds
from repro.core import pruning as jpruning
from repro.data import images as jimages
from repro_torch.accel import apps as tapps
from repro_torch.accel import batch_oracle as tbo
from repro_torch.accel import synth as tsynth
from repro_torch.core import dataset as tds
from repro_torch.core import pruning as tpruning

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

APPS = ["sobel", "gaussian", "fir15", "dct8", "kmeans"]
# the reference's own bars for the scalar path against the batched one
# (tests/test_batch_oracle.py): SSIM atol 2e-5, PPA rtol 1e-6
SSIM_ATOL, PPA_RTOL = 2e-5, 1e-6
BUILD = dict(n_samples=8, seed=4, n_images=1, img_size=16)
TIMING_FIELDS = ("slack", "criticality", "err_mae", "err_wce")


@pytest.fixture(scope="module")
def pruned():
    return jpruning.prune_library()[0], tpruning.prune_library()[0]


def _entries(pruned, name):
    kinds = {n.kind for n in japps.APPS[name].unit_nodes}
    return ({k: pruned[0][k] for k in kinds}, {k: pruned[1][k] for k in kinds})


def _choices(name, jent, tent, n, seed):
    """n sampled configurations as (config, JAX choice, port choice)."""
    japp, tapp = japps.APPS[name], tapps.APPS[name]
    out = []
    for cfg in jds.sample_configs(japp, n, seed=seed, lib_entries=jent):
        out.append((cfg,
                    {u.id: jent[u.kind][i]
                     for u, i in zip(japp.unit_nodes, cfg)},
                    {u.id: tent[u.kind][i]
                     for u, i in zip(tapp.unit_nodes, cfg)}))
    return out


@pytest.mark.parametrize("name", APPS)
def test_scalar_labels_match_reference(pruned, name):
    """`accuracy_ssim` and `probe_scalar` within SSIM atol 2e-5 of the
    reference; `static_timing`: the crit bits equal, tmax, slack,
    criticality and the accumulated errors allclose at 1e-6 (float64 sums;
    the unit metrics are float32 reductions in another order), the probe
    fields at 2e-5."""
    japp, tapp = japps.APPS[name], tapps.APPS[name]
    jent, tent = _entries(pruned, name)
    imgs = jimages.image_set(1, 16)
    jinp = jnp.asarray(imgs.astype(np.int32) if name == "kmeans"
                       else jimages.gray(imgs))
    tinp = tapps.app_inputs(name, imgs, "cpu")
    np.testing.assert_array_equal(tinp.numpy(), np.asarray(jinp))
    jexact = japp.run(japps.make_impls(japp, japps.exact_choice(japp)), jinp)
    texact = tapp.run(tapps.make_impls(tapp, tapps.exact_choice(tapp)), tinp)
    for cfg, jch, tch in _choices(name, jent, tent, 2, seed=2):
        want = japps.accuracy_ssim(japp, jch, jinp, jexact)
        got = tapps.accuracy_ssim(tapp, tch, tinp, texact)
        assert abs(got - want) <= SSIM_ATOL, (cfg, got, want)
        assert tapps.accuracy_ssim(tapp, tch, tinp) == got
        jt = jsynth.static_timing(japp, jch)     # probe_scalar inside
        tt = tsynth.static_timing(tapp, tch, "cpu")
        tp = tapps.probe_scalar(tapp, tch, "cpu")
        assert set(tp) == set(tapps.PROBE_FIELDS)
        jp = next(iter(jt["nodes"].values()))
        for f in tp:
            assert abs(tp[f] - jp[f]) <= SSIM_ATOL, (cfg, f)
        assert tt["tmax"] == pytest.approx(jt["tmax"], rel=1e-6)
        assert list(tt["nodes"]) == list(jt["nodes"])
        for nid, row in tt["nodes"].items():
            ref = jt["nodes"][nid]
            assert row["on_critical_path"] == ref["on_critical_path"]
            for f in TIMING_FIELDS:
                assert row[f] == pytest.approx(ref[f], rel=1e-6, abs=1e-6), \
                    (cfg, nid, f)
            for f in tapps.PROBE_FIELDS:
                assert row[f] == tp[f]
        crit = {n for n, r in tt["nodes"].items() if r["on_critical_path"]}
        assert crit == tsynth.synthesize(tapp, tch)["critical_nodes"]


@pytest.mark.parametrize("name", APPS)
def test_crit_sets_match(pruned, name):
    """`batch_oracle.crit_sets` equal to the reference's on the same block,
    and to the scalar oracle's critical sets."""
    jent, tent = _entries(pruned, name)
    choices = _choices(name, jent, tent, 32, seed=6)
    C = np.asarray([c for c, _, _ in choices], np.int64)
    got = tbo.crit_sets(tbo.synthesize_batch(tapps.APPS[name], tent, C))
    assert got == jbo.crit_sets(jbo.synthesize_batch(japps.APPS[name], jent,
                                                     C))
    for (_, _, tch), s in list(zip(choices, got))[:8]:
        assert s == tsynth.synthesize(tapps.APPS[name], tch)["critical_nodes"]


@pytest.fixture(scope="module")
def loop_builds(pruned):
    """name -> (the port's loop build, its batched build)."""
    out = {}
    for name in APPS:
        tent = _entries(pruned, name)[1]
        out[name] = tuple(
            tds.build(name, lib_entries=tent, label_backend=b, device="cpu",
                      **BUILD) for b in ("loop", "batched"))
    return out


@pytest.mark.parametrize("name", APPS)
def test_loop_build_matches_batched_build(loop_builds, name):
    """The port's loop backend against its batched backend: configs, crit
    bits, adjacency and masks equal; features bit-identical (every
    column: the scalar and the batched functional model reduce SSIM in
    the same order on the CPU); PPA at rtol 1e-6 and SSIM at atol 2e-5,
    the reference's bars."""
    lp, bt = loop_builds[name]
    assert lp.configs == bt.configs and len(lp.configs) == BUILD["n_samples"]
    np.testing.assert_array_equal(lp.crit, bt.crit)
    np.testing.assert_array_equal(lp.x, bt.x)
    for k in ("adj", "mask", "unit_mask"):
        np.testing.assert_array_equal(getattr(lp, k), getattr(bt, k))
    np.testing.assert_allclose(lp.y_raw[:, :3], bt.y_raw[:, :3],
                               rtol=PPA_RTOL)
    np.testing.assert_allclose(lp.y_raw[:, 3], bt.y_raw[:, 3],
                               atol=SSIM_ATOL)


@pytest.mark.parametrize("name", APPS)
def test_loop_build_matches_reference_loop_build(pruned, loop_builds, name):
    """The port's loop build against the reference's: configs, crit bits,
    adjacency and masks equal; y_raw and x allclose at the slice test's
    rtol 1e-5 (x also atol 1e-5)."""
    jent = _entries(pruned, name)[0]
    want = jds.build(name, lib_entries=jent, label_backend="loop", **BUILD)
    got = loop_builds[name][0]
    assert got.configs == want.configs
    np.testing.assert_array_equal(got.crit, want.crit)
    for k in ("adj", "mask", "unit_mask"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    np.testing.assert_allclose(got.y_raw, want.y_raw, rtol=1e-5)
    np.testing.assert_allclose(got.x, want.x, rtol=1e-5, atol=1e-5)


def test_build_rejects_unknown_backend():
    with pytest.raises(ValueError, match="label_backend"):
        tds.build("sobel", n_samples=4, n_images=2, img_size=32,
                  label_backend="nope", device="cpu")
