"""The port engine's ``devices=`` split on the CPU, as
tests/test_engine_sharded.py holds the reference's on forced host devices.

One CPU device named k times stands for k devices: each chunk's config
rows split over the largest prefix of them that divides the chunk, and
every row must equal the ``devices=1`` engine's bit for bit, on
``__call__`` and on ``submit``/``drain``, with the memo cache on and off
(sobel, gsae with 2 layers of 16, 48 + 48 configs, chunk 16, untrained
parameters from a seed). Then the ensemble and mpnn engines, the
reference's rows on the carried parameters, and the shard cap in the
stats.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import gnn as jgnn
from repro.core import models as jmodels
from repro.core.engine import SurrogateEngine as JEngine
from repro_torch.accel import apps as tapps
from repro_torch.core import dataset as tds
from repro_torch.core import gnn as tgnn
from repro_torch.core import models as tmodels
from repro_torch.core import pruning as tpruning
from repro_torch.core import training as ttr
from repro_torch.core.engine import SurrogateEngine
from repro_torch.kernels import ops

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = torch.device("cpu")
WIDTHS = (1, 2, 8)


@pytest.fixture(scope="module")
def sobel():
    pruned = tpruning.prune_library()[0]
    app = tapps.APPS["sobel"]
    entries = {k: pruned[k] for k in {n.kind for n in app.unit_nodes}}
    ds = tds.build("sobel", n_samples=24, seed=0, lib_entries=entries,
                   device="cpu")
    rng = np.random.default_rng(1)
    sizes = [len(entries[n.kind]) for n in app.unit_nodes]
    cfg_a = [tuple(int(rng.integers(0, s)) for s in sizes)
             for _ in range(48)]
    cfg_b = [tuple(int(rng.integers(0, s)) for s in sizes)
             for _ in range(48)]
    return app, entries, ds, cfg_a, cfg_b


def _cfg(ds, arch="gsae"):
    return tmodels.TwoStageConfig(gnn=tgnn.GNNConfig(
        arch=arch, n_layers=2, hidden=16, feature_dim=ds.x.shape[-1]))


def _rows(build, cfg_a, cfg_b, cache):
    """(call rows, drain rows, engine) of one engine: a direct call of
    cfg_a, then cfg_b as four queued submissions fused by one drain."""
    eng = build(cache)
    call = eng(cfg_a)
    futs = [eng.submit(cfg_b[i:i + 12]) for i in range(0, 48, 12)]
    assert eng.drain() == 4
    drain = np.concatenate([f.result(timeout=60) for f in futs], 0)
    return call, drain, eng


def _check_widths(make, sobel):
    """Rows of ``make(devices, cache)`` at every width against
    ``devices=1``, bit for bit; returns the one-device rows."""
    _, _, _, cfg_a, cfg_b = sobel
    for cache in (True, False):
        one = _rows(lambda c: make(1, c), cfg_a, cfg_b, cache)
        assert one[2].devices == 1 and one[2].stats.devices == 1
        for k in WIDTHS:
            devs = [CPU] * k
            got = _rows(lambda c: make(devs, c), cfg_a, cfg_b, cache)
            assert got[2].devices == k and got[2].stats.devices == k
            assert got[2].stats.as_dict()["devices"] == k
            np.testing.assert_array_equal(got[0], one[0])
            np.testing.assert_array_equal(got[1], one[1])
            assert got[2].stats.chunks == one[2].stats.chunks
    return one


def test_gsae_rows_bit_identical_across_1_2_and_8_devices(sobel,
                                                          monkeypatch):
    """Every chunk of 16 splits into 16/k rows a device; the slices are
    counted as they reach the layer function."""
    app, entries, ds, cfg_a, _ = sobel
    cfg = _cfg(ds)
    params = tmodels.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    batches = []
    real = ops.gnn_mp
    monkeypatch.setattr(ops, "gnn_mp", lambda adj, h, *a: (
        batches.append(h.shape[0]), real(adj, h, *a))[1])

    def make(devices, cache):
        return SurrogateEngine.from_gnn(cfg, params, ds, app, entries,
                                        chunk_size=16, devices=devices,
                                        cache=cache, device="cpu")
    one = _check_widths(make, sobel)
    np.testing.assert_array_equal(one[0][:12], make(1, True)(cfg_a[:12]))
    # one direct call of 48 configs over 8 devices: 3 chunks x 8 slices
    # of 2 rows, 2 layers a stage, 2 stages
    eng = make([CPU] * 8, False)
    batches.clear()
    eng(cfg_a)
    assert batches == [2] * (3 * 8 * 4)


def test_a_chunk_no_device_prefix_divides_runs_whole(sobel):
    """A ragged chunk of 13 rows over 8 devices: no prefix of more than
    one device divides 13, so it runs on the first device as it is."""
    app, entries, ds, cfg_a, _ = sobel
    cfg = _cfg(ds)
    params = tmodels.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    one = SurrogateEngine.from_gnn(cfg, params, ds, app, entries,
                                   chunk_size=16, device="cpu")
    eight = SurrogateEngine.from_gnn(cfg, params, ds, app, entries,
                                     chunk_size=16, devices=[CPU] * 8,
                                     device="cpu")
    np.testing.assert_array_equal(eight(cfg_a[:29]), one(cfg_a[:29]))
    assert eight.stats.chunks == 2


def test_devices_counts_resolve_as_the_reference(sobel):
    """0 is every local device of the type (one CPU), N at most N of
    them; a negative count or a bare name raises."""
    app, entries, ds, _, _ = sobel
    cfg = _cfg(ds)
    params = tmodels.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    for devices in (0, "auto", 4, 1, None):
        eng = SurrogateEngine.from_gnn(cfg, params, ds, app, entries,
                                       chunk_size=16, devices=devices,
                                       device="cpu")
        assert eng.devices == 1
    for bad in (-1, "cpu"):
        with pytest.raises(ValueError, match="devices"):
            SurrogateEngine.from_gnn(cfg, params, ds, app, entries,
                                     devices=bad, device="cpu")


def test_mpnn_rows_bit_identical_across_devices(sobel):
    """mpnn runs its whole model at the chunk size's rows on every
    slice."""
    app, entries, ds, _, _ = sobel
    cfg = _cfg(ds, "mpnn")
    params = tmodels.init(torch.Generator().manual_seed(3), cfg,
                          device="cpu")

    def make(devices, cache):
        return SurrogateEngine.from_gnn(cfg, params, ds, app, entries,
                                        chunk_size=16, devices=devices,
                                        cache=cache, device="cpu")
    _check_widths(make, sobel)


def test_ensemble_rows_bit_identical_across_devices(sobel):
    """A 3-member gsae + gcn ensemble: every member runs on every slice;
    the mean and the std rows equal the one-device engine's."""
    app, entries, ds, cfg_a, _ = sobel
    cfg = _cfg(ds)
    ens, _ = ttr.fit_ensemble(cfg, ds, ttr.TrainConfig(epochs=1,
                                                       batch_size=8),
                              n_members=3, archs=["gsae", "gcn", "gsae"],
                              device="cpu")

    def make(devices, cache):
        return SurrogateEngine.from_gnn_ensemble(
            ens, ds, app, entries, chunk_size=16, devices=devices,
            cache=cache, device="cpu")
    _check_widths(make, sobel)
    one, eight = make(1, True), make([CPU] * 8, True)
    m1, s1 = one.predict_with_uncertainty(cfg_a)
    m8, s8 = eight.predict_with_uncertainty(cfg_a)
    np.testing.assert_array_equal(m8, m1)
    np.testing.assert_array_equal(s8, s1)
    assert eight.backend == one.backend == "torch-ensemble"


def test_split_rows_match_the_reference_engine(sobel):
    """The reference's engine (pure JAX, one device) on the same initial
    parameters: the port's rows over 8 devices at the bars of
    tests/test_torch_engine_side.py."""
    from repro.accel import apps as japps
    from repro.core import dataset as jds
    from repro.core import graph as jgraph
    import dataclasses
    app, entries, ds, cfg_a, _ = sobel
    g = dict(arch="gsae", n_layers=2, hidden=16, feature_dim=ds.x.shape[-1])
    jcfg = jmodels.TwoStageConfig(gnn=jgnn.GNNConfig(**g))
    tcfg = tmodels.TwoStageConfig(gnn=tgnn.GNNConfig(**g))
    jparams = jmodels.init(jax.random.PRNGKey(0), jcfg)
    tparams = tmodels.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    kw = {f.name: getattr(ds, f.name) for f in dataclasses.fields(ds)
          if f.name != "graph"}
    jd = jds.AccelDataset(graph=jgraph.build_graph(japps.APPS["sobel"]),
                          **kw)
    jeng = JEngine.from_gnn(jcfg, jparams, jd, japps.APPS["sobel"], entries,
                            chunk_size=16, use_kernel="off")
    teng = SurrogateEngine.from_gnn(tcfg, tparams, ds, app, entries,
                                    chunk_size=16, devices=[CPU] * 8,
                                    device="cpu")
    jy, ty = jeng(cfg_a), teng(cfg_a)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    assert jeng.devices == 1 and teng.devices == 8
