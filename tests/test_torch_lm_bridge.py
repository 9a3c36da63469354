"""ApproxPilot-LM in the port (`repro_torch.core.lm_bridge`) against the
JAX package's `repro.core.lm_bridge` on the CPU.

The op graph, the roofline oracle and the NSGA-III search are NumPy on
both sides, so under the reference's constants (the TPU v5e's 197e12 and
819e9, patched into the port's module) they are held bit for bit. The
surrogate is trained by the port's own trainer (its initial weights come
from a torch generator, not the reference's threefry), so it is held to
the properties `tests/test_system.py` asks of the reference's. Every
test runs in float32 with TF32 off.
"""
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.core import lm_bridge as jbridge
from repro.launch import roofline as jroof
from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape
from repro_torch.core import lm_bridge
from repro_torch.core import training
from repro_torch.kernels import ops
from repro_torch.launch import roofline

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CELLS = [(a, s) for a in sorted(ARCHS) for s in sorted(SHAPES)]
# the surrogate's queries against `models.predict` of the same weights
# (the engine's own bar on normalized outputs, `lm_bridge.PARITY_ATOL`)
ENGINE_ATOL = 2e-3


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the surrogate's tiny training steps: with
    a thread per core in each of several test workers, the threads of
    every small op contend for the cores. No result depends on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reference_constants(monkeypatch):
    """The reference's roofline constants in the port's module."""
    monkeypatch.setattr(lm_bridge, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(lm_bridge, "HBM_BW", jroof.HBM_BW)


def test_constants_are_the_h100s():
    assert lm_bridge.PEAK_FLOPS == roofline.PEAK_FLOPS == 989e12
    assert lm_bridge.HBM_BW == roofline.HBM_BW == 3.35e12


@pytest.mark.parametrize("arch,shape", CELLS)
def test_op_graph_matches_reference(arch, shape):
    ops_t, adj_t = lm_bridge.op_graph(get_arch(arch), get_shape(shape))
    ops_j, adj_j = jbridge.op_graph(J_ARCHS[arch], J_SHAPES[shape])
    assert ops_t == ops_j
    assert adj_t.dtype == adj_j.dtype and np.array_equal(adj_t, adj_j)


@pytest.mark.parametrize("arch,shape", [
    ("granite-3-2b", "decode_32k"), ("qwen2.5-32b", "train_4k"),
    ("moonshot-v1-16b-a3b", "prefill_32k"), ("rwkv6-3b", "long_500k")])
def test_oracle_bit_equal_under_reference_constants(reference_constants,
                                                    arch, shape):
    cfg_t, sh_t = get_arch(arch), get_shape(shape)
    ops_t, _ = lm_bridge.op_graph(cfg_t, sh_t)
    ops_j, _ = jbridge.op_graph(J_ARCHS[arch], J_SHAPES[shape])
    ev_t, one_t = lm_bridge.oracle(cfg_t, sh_t, ops_t)
    ev_j, one_j = jbridge.oracle(J_ARCHS[arch], J_SHAPES[shape], ops_j)
    rng = np.random.default_rng(0)
    choices = [tuple(int(c) for c in rng.integers(0, 3, len(ops_t)))
               for _ in range(64)]
    got, want = ev_t(choices), ev_j(choices)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for c in choices:
        assert one_t(c) == one_j(c)


def test_oracle_uses_the_h100_constants():
    """Unpatched, the oracle's bf16 step time is the H100 roofline's."""
    cfg, sh = get_arch("granite-3-2b"), get_shape("decode_32k")
    ops_t, _ = lm_bridge.op_graph(cfg, sh)
    _, one = lm_bridge.oracle(cfg, sh, ops_t)
    (t, _, _), _ = one([0] * len(ops_t))
    want = sum(max(o["f"] / 989e12, o["b"] / 3.35e12) for o in ops_t)
    assert t == want


def test_run_dse_bit_identical_under_reference_constants(reference_constants):
    out_t = lm_bridge.run_dse(get_arch("granite-3-2b"),
                              get_shape("decode_32k"), budget=400, seed=0)
    out_j = jbridge.run_dse(J_ARCHS["granite-3-2b"], J_SHAPES["decode_32k"],
                            budget=400, seed=0)
    assert out_t["ops"] == out_j["ops"]
    assert out_t["baseline"] == out_j["baseline"]
    assert len(out_t["pareto"]) == len(out_j["pareto"]) > 0
    for (ct, ot), (cj, oj) in zip(out_t["pareto"], out_j["pareto"]):
        assert tuple(map(int, ct)) == tuple(map(int, cj))
        assert np.array_equal(ot, oj)
    counts = ("calls", "configs", "cache_hits", "evaluated", "padded",
              "chunks", "max_batch")
    assert ({k: out_t["engine"][k] for k in counts}
            == {k: out_j["engine"][k] for k in counts})
    # test_system.py's properties of the search
    best_cfg, best_obj = out_t["best"]
    assert best_obj[0] <= out_t["baseline"]["time"]
    assert best_obj[2] <= 6.0
    assert out_t["baseline"]["critical_op"] in out_t["ops"]


def _surrogate_properties(m, predict):
    """tests/test_system.py::test_lm_bridge_surrogate_critical_op."""
    assert m["critical_path"]["accuracy"] > 0.85
    pred = predict([(0,) * 7, (1,) * 7])       # bf16 vs fp8 everywhere
    assert pred[1, 0] < pred[0, 0]             # fp8 predicted faster
    assert pred[1, 2] > pred[0, 2]             # ...at higher penalty


def test_train_surrogate_single():
    m, predict = lm_bridge.train_surrogate(
        get_arch("qwen2.5-32b"), get_shape("train_4k"), n_samples=250,
        epochs=20, device="cpu")
    _surrogate_properties(m, predict)
    assert predict.backend == "gnn-lm"
    assert predict.chunk_size == 256 and predict.fixed_shape
    assert set(m) == {"area", "power", "latency", "ssim", "critical_path"}


def test_train_surrogate_ensemble_serves_the_members_mean(monkeypatch):
    calls, fitted = [], []
    real_mp, real_fit = ops.gnn_mp, training.fit_ensemble

    def counted(*args):
        calls.append(args[1].shape)
        return real_mp(*args)

    def kept(*args, **kwargs):
        fitted.append(real_fit(*args, **kwargs)[0])
        return fitted[-1], None

    monkeypatch.setattr(ops, "gnn_mp", counted)
    monkeypatch.setattr(training, "fit_ensemble", kept)
    m, predict = lm_bridge.train_surrogate(
        get_arch("qwen2.5-32b"), get_shape("train_4k"), n_samples=250,
        epochs=20, ensemble=2, device="cpu")
    _surrogate_properties(m, predict)
    for target in ("area", "power", "latency", "ssim"):
        assert "mean_std" in m[target]
    # the served rows are the fitted members' mean, as
    # `training.ensemble_predict` computes it, denormalized
    cfg, sh = get_arch("qwen2.5-32b"), get_shape("train_4k")
    ops_g, adj = lm_bridge.op_graph(cfg, sh)
    _, one = lm_bridge.oracle(cfg, sh, ops_g)
    ds, A1, feats = lm_bridge._samples(ops_g, adj, one, 250, 0)
    (ens,) = fitted
    assert ens.n_members == 2
    rng = np.random.default_rng(3)
    choices = [tuple(int(c) for c in rng.integers(0, 3, 7))
               for _ in range(37)]
    X = np.stack([feats(c) for c in choices])
    mean, _, _ = training.ensemble_predict(
        ens, np.broadcast_to(A1, (37, 7, 7)), X, np.ones((37, 7)),
        device="cpu")
    calls.clear()
    predict.reset_stats()
    got = predict(choices)
    np.testing.assert_allclose(got, ds.denorm_y(mean.numpy()),
                               rtol=0, atol=ENGINE_ATOL * ds.y_std.max())
    # 37 configs (those not memoized yet): one chunk padded to 64 rows, 3
    # gsae layers a stage, two stages, two members; every layer through
    # gnn_mp at 7 nodes
    assert len(calls) == 2 * 2 * 3
    assert {s[0] for s in calls} == {64} and {s[1] for s in calls} == {7}
    assert predict.stats.evaluated + predict.stats.padded == 64


def test_train_surrogate_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_bridge.train_surrogate(get_arch("qwen2.5-32b"),
                                  get_shape("train_4k"), n_samples=20,
                                  epochs=1)


@pytest.mark.gpu
def test_surrogate_queries_launch_gnn_mp_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import gnn_mp as kmp
    m, predict = lm_bridge.train_surrogate(
        get_arch("qwen2.5-32b"), get_shape("train_4k"), n_samples=250,
        epochs=20)
    _surrogate_properties(m, predict)
    kmp.LAUNCHES.reset()
    predict([(0,) * 7, (2,) * 7, (1, 0, 2, 1, 0, 2, 1)])
    assert kmp.LAUNCHES.value == 2 * 3      # two stages of three layers
