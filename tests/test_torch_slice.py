"""The slice end to end at a small size for each of the five
accelerators, JAX package against the port on the CPU: app context ->
labeled dataset -> two-stage gsae surrogate (2 layers, hidden 16) on the
reference's initial weights -> `SurrogateEngine.from_gnn`, plus
`from_oracle` on both sides."""
import jax
import numpy as np
import pytest
import torch

from repro.core import dataset as jds
from repro.core import gnn as jgnn
from repro.core import models as jmodels
from repro.core import pipeline as jpipeline
from repro.core.engine import SurrogateEngine as JEngine
from repro_torch.core import dataset as tds
from repro_torch.core import gnn as tgnn
from repro_torch.core import models as tmodels
from repro_torch.core import pipeline as tpipeline
from repro_torch.core.engine import SurrogateEngine as TEngine

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N_SAMPLES, N_LAYERS, HIDDEN = 64, 2, 16


@pytest.fixture(scope="module",
                params=["gaussian", "sobel", "fir15", "dct8", "kmeans"])
def both(request):
    app = request.param
    jctx = jpipeline.app_context(app)
    tctx = tpipeline.app_context(app, device="cpu")
    jd = jds.build(app, n_samples=N_SAMPLES, lib_entries=jctx.entries)
    td = tds.build(app, n_samples=N_SAMPLES, lib_entries=tctx.entries,
                   device="cpu")
    return jctx, tctx, jd, td


def test_context_and_dataset_match(both):
    """Pruned entries, images and exact output identical; configs and
    crit labels identical; y_raw allclose at rtol 1e-5 (float32 SSIM
    reductions in another order; PPA is the same float64 arithmetic)."""
    jctx, tctx, jd, td = both
    for k in jctx.entries:
        assert [e.inst.name for e in jctx.entries[k]] == \
            [e.inst.name for e in tctx.entries[k]]
    np.testing.assert_array_equal(tctx.inp.numpy(), np.asarray(jctx.inp))
    np.testing.assert_array_equal(tctx.exact_out.numpy(),
                                  np.asarray(jctx.exact_out))
    assert tctx.space == jctx.space
    assert td.configs == jd.configs
    np.testing.assert_array_equal(td.crit, jd.crit)
    np.testing.assert_array_equal(td.mask, jd.mask)
    np.testing.assert_array_equal(td.unit_mask, jd.unit_mask)
    np.testing.assert_allclose(td.y_raw, jd.y_raw, rtol=1e-5)
    np.testing.assert_allclose(td.x, jd.x, rtol=1e-5, atol=1e-5)


def _engines(both):
    jctx, tctx, jd, td = both
    F = jd.x.shape[-1]
    jcfg = jmodels.TwoStageConfig(gnn=jgnn.GNNConfig(
        arch="gsae", n_layers=N_LAYERS, hidden=HIDDEN, feature_dim=F))
    tcfg = tmodels.TwoStageConfig(gnn=tgnn.GNNConfig(
        arch="gsae", n_layers=N_LAYERS, hidden=HIDDEN, feature_dim=F))
    jparams = jmodels.init(jax.random.PRNGKey(0), jcfg)
    tparams = tmodels.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    jeng = JEngine.from_gnn(jcfg, jparams, jd, jctx.app, jctx.entries,
                            chunk_size=16, use_kernel="off")
    teng = TEngine.from_gnn(tcfg, tparams, td, tctx.app, tctx.entries,
                            chunk_size=16, device="cpu")
    return jeng, teng


def test_gnn_engine_rows_match(both):
    """Rows on fresh configs: normalized by each side's dataset stats,
    allclose at atol 1e-4 (float32 GNN, the gsae layer through the fused
    scaled-adjacency form on the port); denormalized at rtol 1e-5."""
    jctx, _, jd, td = both
    jeng, teng = _engines(both)
    assert teng.backend == "torch"
    fresh = [c for c in jds.sample_configs(jctx.app, 60, seed=9,
                                           lib_entries=jctx.entries)
             if c not in set(jd.configs)][:32]
    jy, ty = jeng(fresh), teng(fresh)
    assert ty.shape == (len(fresh), 4) and np.isfinite(ty).all()

    def norm(y, d):
        y = y.copy()
        y[:, 3] = 1 - y[:, 3]
        return (y - d.y_mean) / d.y_std
    np.testing.assert_allclose(norm(ty, td), norm(jy, jd), atol=1e-4)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    assert (teng.stats.chunks, teng.stats.padded) == \
        (jeng.stats.chunks, jeng.stats.padded)
    np.testing.assert_array_equal(teng(fresh[:5]), ty[:5])   # memo
    assert teng.stats.cache_hits == 5


def test_oracle_engine_rows_match(both):
    """PPA columns: the same float64 arithmetic (rtol 1e-12); 1 - SSIM at
    atol 1e-6."""
    jctx, tctx, jd, _ = both
    cfgs = jd.configs[:20]
    jy = JEngine.from_oracle(jctx.app, jctx.entries, jctx.inp,
                             jctx.exact_out)(cfgs)
    ty = TEngine.from_oracle(tctx.app, tctx.entries, tctx.inp,
                             tctx.exact_out)(cfgs)
    np.testing.assert_allclose(ty[:, :3], jy[:, :3], rtol=1e-12)
    np.testing.assert_allclose(ty[:, 3], jy[:, 3], atol=1e-6)
