"""The port's core modules against the JAX package: Gaussian feature rows,
the GNN zoo and the two-stage model on carried weights, the engine's
semantics, the device rule, and the import guard."""
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.accel import apps as japps
from repro.core import dataset as jds
from repro.core import gnn as jgnn
from repro.core import graph as jgraph
from repro.core import models as jmodels
from repro.core import pruning as jpruning
from repro_torch import device as device_lib
from repro_torch.accel import apps as tapps
from repro_torch.core import dataset as tds
from repro_torch.core import gnn as tgnn
from repro_torch.core import graph as tgraph
from repro_torch.core import models as tmodels
from repro_torch.core import pruning as tpruning
from repro_torch.core.engine import SurrogateEngine

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = Path(__file__).resolve().parents[1]
GAUSS_COUNTS = {"add16": 21, "mul8x4": 32}


# --------------------------------------------------------------------------
# features
# --------------------------------------------------------------------------

def test_gaussian_feature_rows_match():
    """Raw and normalized rows: integer-valued columns (one-hots, crit
    bit, approximation level, padding) identical; float columns allclose
    at 1e-6 (float32 error metrics and probe SSIM reduced in another
    order)."""
    japp, tapp = japps.APPS["gaussian"], tapps.APPS["gaussian"]
    jent = jpruning.prune_library(GAUSS_COUNTS)[0]
    tent = tpruning.prune_library(GAUSS_COUNTS)[0]
    jg, tg = jgraph.build_graph(japp), tgraph.build_graph(tapp)
    assert tg.node_ids == jg.node_ids and np.array_equal(tg.adj, jg.adj)
    C = np.asarray(jds.sample_configs(japp, 24, seed=3, lib_entries=jent))
    assert [tuple(c) for c in C] == tds.sample_configs(tapp, 24, seed=3,
                                                       lib_entries=tent)
    jf = jds.ConfigFeaturizer(jg, japp, jent, 32)
    tf = tds.ConfigFeaturizer(tg, tapp, tent, 32, device="cpu")
    crit = (np.random.default_rng(0).random((24, len(jg.node_ids)))
            > 0.5).astype(np.float32)
    want, got = jf.raw(C, crit=crit), tf.raw(C, crit=crit)
    np.testing.assert_array_equal(tf.adj, jf.adj)
    np.testing.assert_array_equal(tf.mask, jf.mask)
    schema = jgraph.ACTIVE_SCHEMA
    exact_cols = ~schema.normalize_mask()
    exact_cols[schema.col("unit_stats", "approx_level")] = True
    np.testing.assert_array_equal(got[..., exact_cols], want[..., exact_cols])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    flat = want.reshape(-1, want.shape[-1])
    x_mean = flat.mean(0) * schema.normalize_mask()
    x_std = np.where(schema.normalize_mask(), flat.std(0) + 1e-6, 1.0)
    jf.set_norm(x_mean, x_std)
    tf.set_norm(x_mean, x_std)
    want_n, got_n = jf.normalized(C), tf.normalized(C)
    np.testing.assert_array_equal(got_n[..., exact_cols],
                                  want_n[..., exact_cols])
    np.testing.assert_allclose(got_n, want_n, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# models on carried weights
# --------------------------------------------------------------------------

def _graph_batch(B=3, N=10, F=8, seed=0):
    rng = np.random.default_rng(seed)
    adj = (rng.random((B, N, N)) > 0.6).astype(np.float32)
    adj = np.minimum(adj + adj.transpose(0, 2, 1) + np.eye(N, dtype=np.float32),
                     1.0)
    x = rng.standard_normal((B, N, F)).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, 7:] = 0.0
    return adj, x, mask


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ["gcn", "gsae", "gat", "mpnn"])
@pytest.mark.parametrize("node_level", [False, True])
def test_gnn_apply_matches_on_carried_params(arch, node_level):
    """float32 with another summation order: rtol/atol 1e-5."""
    cfg = dict(arch=arch, n_layers=2, hidden=16, feature_dim=8,
               node_level=node_level, out_dim=1 if node_level else 4)
    jcfg, tcfg = jgnn.GNNConfig(**cfg), tgnn.GNNConfig(**cfg)
    np_params = _np_tree(jgnn.init_params(jax.random.PRNGKey(1), jcfg))
    tparams = tmodels.params_from_numpy((np_params, np_params), "cpu").stage1
    adj, x, mask = _graph_batch()
    want = np.asarray(jgnn.apply(jcfg, np_params, *map(jnp.asarray,
                                                       (adj, x, mask))))
    got = tgnn.apply(tcfg, tparams, *map(torch.from_numpy, (adj, x, mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["gsae", "gcn"])
def test_two_stage_predict_matches_on_carried_params(arch):
    """Targets at rtol/atol 1e-5; the stage-1 bits that feed stage 2 agree
    (logits allclose and away from the 0.5 threshold here)."""
    F = jgraph.ACTIVE_SCHEMA.dim
    jcfg = jmodels.TwoStageConfig(gnn=jgnn.GNNConfig(
        arch=arch, n_layers=2, hidden=16, feature_dim=F))
    tcfg = tmodels.TwoStageConfig(gnn=tgnn.GNNConfig(
        arch=arch, n_layers=2, hidden=16, feature_dim=F))
    np_params = _np_tree(jmodels.init(jax.random.PRNGKey(2), jcfg))
    tparams = tmodels.params_from_numpy(np_params, "cpu")
    adj, x, mask = _graph_batch(B=4, N=12, F=F, seed=1)
    x[..., jgraph.CRIT_IDX] = 0.0
    jy, jl = jmodels.predict(jcfg, np_params, *map(jnp.asarray,
                                                   (adj, x, mask)))
    ty, tl = tmodels.predict(tcfg, tparams, *map(torch.from_numpy,
                                                 (adj, x, mask)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ["gsae", "gcn", "gat", "mpnn"])
def test_engine_predict_path_matches_models_predict(arch):
    """The engine's predict: gcn/gsae layers through `ops.gnn_mp` (the
    kernel's plain version here; gsae via the degree-scaled adjacency),
    gat/mpnn through `gnn.layers` — all within fp32 reordering of
    `models.predict` (rtol/atol 1e-5)."""
    from repro_torch.core.engine import _make_predict
    F = tgraph.ACTIVE_SCHEMA.dim
    cfg = tmodels.TwoStageConfig(gnn=tgnn.GNNConfig(
        arch=arch, n_layers=2, hidden=16, feature_dim=F))
    p = tmodels.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    adj, _, mask = _graph_batch(B=2, N=12, F=F, seed=4)
    adj, mask = adj[1], mask[1]                  # nodes 7.. are padding
    X = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (6, 12, F)).astype(np.float32) * mask[:, None])
    X[..., tgraph.CRIT_IDX] = 0.0
    got = _make_predict(cfg, p, adj, mask, torch.device("cpu"))(X)
    want = tmodels.predict(cfg, p, torch.from_numpy(adj).expand(6, 12, 12),
                           X, torch.from_numpy(mask).expand(6, 12))[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["gsae", "gat", "mpnn"])
def test_engine_predict_runs_its_readouts_at_rows(arch, monkeypatch):
    """With ``rows``, the engine's predict runs both readouts at ``rows``
    rows, its layers at the batch's own rows, or at ``rows`` too for the
    architectures in `WHOLE_MODEL_AT_ROWS` (mpnn), and returns the
    batch's rows within fp32 reordering of the unpadded path (rtol/atol
    1e-5)."""
    from repro_torch.core.engine import WHOLE_MODEL_AT_ROWS, _make_predict
    from repro_torch.kernels import ops
    seen = {"layers": set(), "readout": set()}

    def spy(kind, fn, at):
        def wrapped(*a, **k):
            seen[kind].add(a[at].shape[0])
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(tgnn, "layers", spy("layers", tgnn.layers, 3))
    monkeypatch.setattr(ops, "gnn_mp", spy("layers", ops.gnn_mp, 1))
    monkeypatch.setattr(tgnn, "readout", spy("readout", tgnn.readout, 2))
    F = tgraph.ACTIVE_SCHEMA.dim
    cfg = tmodels.TwoStageConfig(gnn=tgnn.GNNConfig(
        arch=arch, n_layers=2, hidden=16, feature_dim=F))
    p = tmodels.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    adj, _, mask = _graph_batch(B=2, N=12, F=F, seed=4)
    adj, mask = adj[1], mask[1]
    X = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (6, 12, F)).astype(np.float32) * mask[:, None])
    X[..., tgraph.CRIT_IDX] = 0.0
    dev = torch.device("cpu")
    want = _make_predict(cfg, p, adj, mask, dev)(X)
    assert seen == {"layers": {6}, "readout": {6}}
    seen = {"layers": set(), "readout": set()}
    got = _make_predict(cfg, p, adj, mask, dev, rows=16)(X)
    assert got.shape == (6, 4)
    assert seen == {"readout": {16}, "layers": {
        16 if arch in WHOLE_MODEL_AT_ROWS else 6}}
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_dropout_follows_the_generator():
    """Dropout only with masks drawn from a generator (`draw_keep`); the
    same seed gives the same mask."""
    cfg = tgnn.GNNConfig(arch="gsae", n_layers=2, hidden=16, feature_dim=8,
                         dropout=0.5)
    p = tgnn.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    adj, x, mask = map(torch.from_numpy, _graph_batch())
    plain = tgnn.apply(cfg, p, adj, x, mask)
    torch.testing.assert_close(tgnn.apply(cfg, p, adj, x, mask), plain,
                               rtol=0, atol=0)
    B, N = x.shape[:2]
    d1 = tgnn.apply(cfg, p, adj, x, mask, keep=tgnn.draw_keep(
        cfg, torch.Generator().manual_seed(5), B, N))
    d2 = tgnn.apply(cfg, p, adj, x, mask, keep=tgnn.draw_keep(
        cfg, torch.Generator().manual_seed(5), B, N))
    torch.testing.assert_close(d1, d2, rtol=0, atol=0)
    assert not torch.allclose(d1, plain)


def test_init_draws_the_reference_distribution():
    cfg = tmodels.TwoStageConfig(gnn=tgnn.GNNConfig(n_layers=2, hidden=64,
                                                    feature_dim=27))
    gen = torch.Generator().manual_seed(0)
    p = tmodels.init(gen, cfg, device="cpu")
    w = p.stage1["layers"][0]["w_self"]
    assert w.shape == (27, 64) and float(w.abs().max()) <= 27 ** -0.5
    assert float(w.abs().max()) > 0.9 * 27 ** -0.5
    assert torch.count_nonzero(p.stage2["layers"][1]["b"]) == 0
    again = tmodels.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(again.stage2["ro_w1"], p.stage2["ro_w1"])


# --------------------------------------------------------------------------
# engine semantics (mirroring tests/test_engine.py)
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


def test_engine_memo_hits_and_in_batch_dedup():
    be = CountingBackend()
    eng = SurrogateEngine(be, chunk_size=64, schema_version=2)
    cfgs = _rand_configs(50, seed=1)
    y1 = eng(cfgs)
    n_unique = len(set(cfgs))
    assert eng.stats.evaluated == sum(be.calls) == n_unique
    perm = np.random.default_rng(2).permutation(len(cfgs))
    np.testing.assert_array_equal(eng([cfgs[i] for i in perm]), y1[perm])
    assert sum(be.calls) == n_unique
    assert eng.stats.cache_hits == 2 * len(cfgs) - n_unique
    assert all(k[0] == 2 for k in eng._cache)        # schema-versioned keys
    c = cfgs[0]
    eng2 = SurrogateEngine(CountingBackend(), chunk_size=64)
    np.testing.assert_array_equal(eng2([c] * 10),
                                  np.repeat(_toy_rows([c]), 10, 0))
    assert eng2.stats.evaluated == 1


def test_engine_ragged_chunks_pad_to_power_of_two_buckets():
    be = CountingBackend()
    eng = SurrogateEngine(be, chunk_size=16, fixed_shape=True)
    cfgs = _rand_configs(37, seed=5)
    np.testing.assert_array_equal(eng(cfgs), _toy_rows(cfgs))
    assert be.calls == [16, 16, 8]
    assert (eng.stats.padded, eng.stats.chunks) == (3, 3)


def test_engine_submit_drain_equals_one_shot():
    eng = SurrogateEngine(CountingBackend(), chunk_size=8, fixed_shape=True)
    reqs = [_rand_configs(n, seed=s) for n, s in ((5, 1), (13, 2), (1, 3))]
    futs = [eng.submit(r) for r in reqs]
    assert eng.pending() == 3
    assert eng.drain() == 3
    for r, f in zip(reqs, futs):
        one_shot = SurrogateEngine(CountingBackend(), chunk_size=8)(r)
        np.testing.assert_array_equal(f.result(timeout=5), one_shot)
    assert eng.stats.batch_occupancy == 3.0


def test_engine_drain_isolates_a_failing_submission():
    def backend(configs):
        if any(c[0] < 0 for c in configs):
            raise IndexError("bad config")
        return _toy_rows(configs)
    eng = SurrogateEngine(backend, chunk_size=8)
    good, bad = eng.submit([(1, 2)]), eng.submit([(-1, 2)])
    eng.drain()
    np.testing.assert_array_equal(good.result(timeout=5), _toy_rows([(1, 2)]))
    with pytest.raises(IndexError):
        bad.result(timeout=5)


def test_engine_nan_guard_heals_then_quarantines():
    seen = {}

    def flaky(configs):
        rows = _toy_rows(configs)
        for i, c in enumerate(configs):
            seen[c] = seen.get(c, 0) + 1
            if c[0] == 7 or (c[0] == 3 and seen[c] == 1):
                rows[i] = np.nan        # 7 stays broken, 3 heals
        return rows
    eng = SurrogateEngine(flaky, chunk_size=8)
    y = eng([(1, 1), (3, 1), (7, 1)])
    np.testing.assert_array_equal(y[:2], _toy_rows([(1, 1), (3, 1)]))
    assert np.all(np.isinf(y[2])) and eng.quarantined == {(7, 1)}
    assert eng.stats.quarantined == 1


def test_engine_retry_hook_counts_reissues():
    class Retry:
        def call(self, fn, arg, on_retry):
            try:
                return fn(arg)
            except ConnectionError as e:
                on_retry(e)
                return fn(arg)
    state = {"n": 0}

    def once_down(configs):
        state["n"] += 1
        if state["n"] == 1:
            raise ConnectionError("transient")
        return _toy_rows(configs)
    eng = SurrogateEngine(once_down, chunk_size=8, retry=Retry())
    np.testing.assert_array_equal(eng([(2, 2)]), _toy_rows([(2, 2)]))
    assert eng.stats.retries == 1


def test_engine_is_thread_safe_under_concurrent_calls():
    eng = SurrogateEngine(CountingBackend(), chunk_size=4, fixed_shape=True)
    cfgs = [_rand_configs(9, seed=s) for s in range(8)]
    out = {}

    def worker(i):
        out[i] = eng(cfgs[i])
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    for i in range(8):
        np.testing.assert_array_equal(out[i], _toy_rows(cfgs[i]))
    assert eng.stats.calls == 8 and eng.stats.configs == 72


# --------------------------------------------------------------------------
# devices and imports
# --------------------------------------------------------------------------

def test_entry_points_without_device_raise_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from repro_torch.core import pipeline
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_lib.resolve()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.app_context("gaussian")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tds.build("gaussian", n_samples=4)
    assert device_lib.resolve("cpu") == torch.device("cpu")


def test_from_gnn_refuses_several_devices():
    """Several devices split the chunks (tests/test_torch_engine_sharded.py);
    what is refused is a count below 0 or a device name in place of a
    count or a list, before anything is built."""
    for bad in (-1, -8, "cuda:1"):
        with pytest.raises(ValueError, match="devices"):
            SurrogateEngine.from_gnn(None, None, None, None, {},
                                     devices=bad, device="cpu")


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of repro_torch, then chip_smoke (import only), in a
    fresh interpreter: neither jax nor repro may load."""
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(modules) >= 20
    assert {"repro_torch.core.training", "repro_torch.core.dse",
            "repro_torch.core.islands", "repro_torch.core.artifacts",
            "repro_torch.core.pipeline", "repro_torch.models.moe",
            "repro_torch.models.rwkv", "repro_torch.launch.serve"} <= \
        set(modules)


def _imported_names(path: Path):
    """(line, module) of every import in a source file, those inside
    functions included, and of every `importlib.import_module` /
    `__import__` call on a string constant."""
    import ast
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module))
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                out.append((node.lineno, node.args[0].value))
    return out


def test_no_port_source_names_jax_or_the_reference_in_any_import():
    """Importing a module runs only its top-level imports; this reads
    every import statement of every port source and of chip_smoke.py,
    the lazy ones inside functions too: none names jax or repro."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "examples" /
              "quickstart_torch.py"]
    bad = [f"{p.relative_to(ROOT)}:{line}: {mod}"
           for p in files for line, mod in _imported_names(p)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    lazy = [mod for line, mod in _imported_names(
        ROOT / "src" / "repro_torch" / "core" / "pipeline.py")]
    assert "repro_torch.accel" in lazy      # `_oracle_eval`'s lazy import
