"""The LM over a (data, model) mesh, part 2: the sharded training steps
("baseline" and "tp", `launch.steps.make_train_step(grad_shardings=,
compute_shardings=)`), the int8 serving presets (`distributed.spmd`
prefill and decode under `cache_shardings`) and the elastic restart
(`launch.train` onto other meshes), on ``[cpu] * n`` meshes against the
port's unsplit steps and the JAX package's unsharded step under plain
``jax.jit``.

Bars: float32 compute, the sharded step within 1e-5 relative of the
unsplit one (another summation order of the same float32 products) and
within `F32_REF` (1e-4 relative L2, the bar of `test_torch_lm_train.py`)
of the reference; bf16 compute, the loss within the reference's own
5e-3 between its presets (`tests/test_sharding.py`) and every parameter
within twice the reference's own bf16-vs-float32 error.
"""
import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED_ARCHS as J_ARCHS
from repro.configs.base import ShapeConfig as JShape
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro_torch.configs import REDUCED_ARCHS as T_ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import meshes as M
from repro_torch.distributed import spmd
from repro_torch.distributed.fault import FaultInjector, HostFailure
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import decoding
from repro_torch.models.layers import params_from_numpy, tree_leaves, tree_map
from repro_torch.optim import adamw

CPU = torch.device("cpu")
F32_TOL = 1e-5
F32_REF = 1e-4
BF16_LOSS = 5e-3
# reduced Granite has 4 heads ("heads_flat": replicated under tp); the
# second config's 16 heads really split over the model axis
CONFIGS = {"granite": {}, "granite-h16": dict(n_heads=16, n_kv_heads=4,
                                              head_dim=4)}


def _mesh(shape):
    axes = ("pod", "data", "model")[-len(shape):]
    return make_mesh(shape, axes, [CPU] * int(np.prod(shape)))


def _cfgs(key, dtype):
    over = dict(CONFIGS[key], dtype=dtype)
    return (dataclasses.replace(J_ARCHS["granite-3-2b"], **over),
            dataclasses.replace(T_ARCHS["granite-3-2b"], **over))


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)],
                            1)
    for r in range(B):               # rows with different label counts
        labels[r, :(0, 5, 2, 9)[r % 4]] = -1
    return {"tokens": toks, "labels": labels}


def _whole(x):
    return x.gather(CPU) if M.is_placed(x) else x


def _rel_max(a, b) -> float:
    a, b = _whole(a).float(), _whole(b).float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _rel_l2(a, b) -> float:
    a = _whole(a).float().numpy()
    b = _whole(b).float().numpy() if isinstance(b, torch.Tensor) \
        or M.is_placed(b) else np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ref_step(jcfg, shape, jp, batch):
    fn = jax.jit(jsteps.make_train_step(jcfg, shape))
    jp2, st, m = fn(jp, jadamw.init(jp),
                    {k: jnp.asarray(v) for k, v in batch.items()})
    return jp2, st, {k: float(v) for k, v in m.items()}


def _port_step(cfg, shape, params, batch, mesh=None, preset=None):
    """The port's step on a copy of ``params``: unsplit, or `plan`'s step
    over ``mesh`` by ``preset`` (the default schedule, as the reference's
    plan has it)."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = tree_map(torch.clone, params)
    if mesh is None:
        fn = tsteps.make_train_step(cfg, shape)
        p, st, m = fn(params, adamw.init(params), tb)
        return p, st, {k: float(v) for k, v in m.items()}
    fn, _s, ins, outs, _d = tsteps.plan(cfg, shape, mesh,
                                        tsteps.resolve_rules(preset))
    P = M.place_tree(params, ins[0])
    O = tsteps.init_opt(P)
    P, O, m = fn(P, O, tb)
    assert O.step.placement == outs[1].step
    for x, pl in zip(tree_leaves(P), tree_leaves(outs[0])):
        assert x.spec == pl.spec
    return P, O, {k: float(v) for k, v in m.items()}


@functools.lru_cache(maxsize=None)
def _float32_runs(key):
    """(config, reference params, port params, batch, the unsplit port
    step, the reference's step) in float32, once per config (the jitted
    reference step compiles once)."""
    jcfg, tcfg = _cfgs(key, "float32")
    jp = jtr.build_param_table(jcfg).init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(tcfg, 8, 16, seed=3)
    unsplit = _port_step(tcfg, ShapeConfig("t", 16, 8, "train",
                                           grad_accum=2), tp, batch)
    ref = _ref_step(jcfg, JShape("t", 16, 8, "train", grad_accum=2), jp,
                    batch)
    return tcfg, tp, batch, unsplit, ref


@pytest.mark.parametrize("key", sorted(CONFIGS))
@pytest.mark.parametrize("preset,shape", [("baseline", (2, 4)),
                                          ("tp", (2, 4)), ("tp", (2, 2)),
                                          ("tp", (2, 2, 2))])
def test_float32_sharded_step_matches_unsplit_and_reference(key, preset,
                                                            shape):
    """grad_accum=2 on 8 rows of ragged labels (over ("pod", "data") on
    the three-axis mesh): loss, grad norm, lr,
    every parameter and moment (the first moment is a tenth of the
    gradient) within 1e-5 (relative L2) of the unsplit port step and
    within 1e-4 of the reference's. The schedule is the plan's default
    (lr 3e-6 at step 1): AdamW's first update g / (|g| + 1e-8) turns a
    float32 rounding of a gradient that cancels to near zero into a
    change of up to 2 lr in that one element."""
    tcfg, tp, batch, (p1, s1, m1), (jp3, s3, m3) = _float32_runs(key)
    shape_t = ShapeConfig("t", 16, 8, "train", grad_accum=2)
    # every model shard computes its own heads (on (2, 4) reduced
    # Granite's one query head each, two shards sharing a KV head) and
    # ff columns
    lay = spmd.Layout(tcfg, _mesh(shape))
    assert lay.split_ff and lay.split_heads
    p2, s2, m2 = _port_step(tcfg, shape_t, tp, batch, _mesh(shape), preset)
    for k in ("loss", "grad_norm", "lr", "moe_aux"):
        assert abs(m2[k] - m1[k]) <= F32_TOL * max(abs(m1[k]), 1e-30), k
        np.testing.assert_allclose(m2[k], m3[k], rtol=F32_REF, atol=1e-7)
    for a, b, c in zip(tree_leaves((p2, s2.m, s2.v)),
                       tree_leaves((p1, s1.m, s1.v)),
                       jax.tree.leaves((jp3, s3.m, s3.v))):
        assert _rel_l2(a, b) <= F32_TOL, (_rel_l2(a, b), a)
        assert _rel_l2(a, c) <= F32_REF


@functools.lru_cache(maxsize=None)
def _bf16_runs():
    """(config, port params, batch, the reference's bf16 step, its
    float32 step) on the 16-head config, once for the file."""
    jcfg, tcfg = _cfgs("granite-h16", "bfloat16")
    jcfg32, _ = _cfgs("granite-h16", "float32")
    jp = jtr.build_param_table(jcfg).init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jshape = JShape("t", 16, 8, "train", grad_accum=2)
    batch = _batch(tcfg, 8, 16, seed=4)
    return (tcfg, tp, batch, _ref_step(jcfg, jshape, jp, batch),
            _ref_step(jcfg32, jshape, jp, batch))


@pytest.mark.parametrize("preset", ["baseline", "tp"])
def test_bf16_sharded_step_within_the_references_bf16_error(preset):
    """bf16 compute on the 16-head config over (2, 4): the loss within
    5e-3 of the reference's bf16 step, each parameter no further from it
    than twice the reference's bf16 step is from its float32 step."""
    tcfg, tp, batch, (jb, _, mb), (j32, _, _) = _bf16_runs()
    p, _, m = _port_step(tcfg, ShapeConfig("t", 16, 8, "train",
                                           grad_accum=2), tp, batch,
                         _mesh((2, 4)), preset)
    assert abs(m["loss"] - mb["loss"]) < BF16_LOSS
    ref_err = max(_rel_l2(torch.from_numpy(np.array(a, np.float32)), b)
                  for a, b in zip(jax.tree.leaves(jb),
                                  jax.tree.leaves(j32)))
    err = max(_rel_l2(a, b) for a, b in zip(tree_leaves(p),
                                            jax.tree.leaves(jb)))
    assert ref_err > 0 and err <= 2 * ref_err, (err, ref_err)


def _serve(tcfg, params, tok, feed=None, mesh=None, preset=None):
    """Prefill the prompt ``tok`` with a horizon of S + T slots, quantize
    the cache to int8, and take T decode steps (the unsplit path, or over
    ``mesh`` by ``preset``'s plan), feeding the tokens ``feed`` (T of
    them; None: T = 4 greedy tokens). Returns (each step's logits, the
    prefill's first, as float32 on the CPU; the tokens fed)."""
    B, S = tok.shape
    T = 4 if feed is None else len(feed)
    toks = []

    def pick(out, t):
        nxt = (out[-1].argmax(-1, keepdim=True).int() if feed is None
               else feed[t])
        toks.append(nxt)
        return nxt
    if mesh is None:
        lg, cache = decoding.prefill(tcfg, params, {"tokens": tok},
                                     max_len=S + T)
        cache = decoding.quantize_cache(tcfg, cache)
        out = [lg.float()]
        for t in range(T):
            lg, cache = decoding.decode_step(tcfg, params, cache,
                                             pick(out, t), S + t)
            out.append(lg[:, 0].float())
        return out, toks
    dshape = ShapeConfig("d", S + T, B, "decode")
    fn, _s, ins, outs, _d = tsteps.plan(tcfg, dshape, mesh,
                                        tsteps.resolve_rules(preset))
    P = M.place_tree(params, ins[0])
    lg, cache = spmd.prefill(tcfg, mesh, P, M.place(tok, M.data_sharding(
        mesh, B, 2)), max_len=S + T)
    cache = spmd.quantize_cache(tcfg, cache)
    assert {k: v.spec for k, v in cache.items()} == \
        {k: v.spec for k, v in ins[1].items()}
    out = [lg.gather(CPU).float()]
    for t in range(T):
        lg, cache = fn(P, cache, pick(out, t), S + t)
        assert lg.spec == outs[0].spec
        out.append(lg.gather(CPU)[:, 0].float())
    return out, toks


@pytest.mark.parametrize("preset", ["kv8", "serve8"])
@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_int8_serving_matches_the_unsplit_int8_path(preset, key):
    """Prefill of 4 prompts of 8 tokens and 4 decode steps (the unsplit
    run's greedy tokens fed to every run) with the int8 cache, its slots
    split over "model" (each shard's partial attention merged by
    log-sum-exp): float32 logits within 1e-5 of the unsplit int8 path's
    (relative to their largest), bf16 within twice the unsplit bf16
    path's own gap to its float32 run."""
    rng = np.random.default_rng(11)
    tok = torch.from_numpy(rng.integers(0, 256, (4, 8))).int()
    for dtype in ("float32", "bfloat16"):
        _, tcfg = _cfgs(key, dtype)
        params = ttr_init(tcfg)
        want, feed = _serve(tcfg, params, tok)
        if dtype == "bfloat16":
            _, c32 = _cfgs(key, "float32")
            ref32, _ = _serve(c32, tree_map(lambda t: t.float(), params),
                              tok, feed)
            own = max(float((a - b).abs().max())
                      for a, b in zip(want, ref32))
        for shape in ((2, 4), (2, 2)):
            got, _ = _serve(tcfg, params, tok, feed, _mesh(shape), preset)
            gap = max(float((a - b).abs().max()) for a, b in zip(got, want))
            scale = max(float(w.abs().max()) for w in want)
            if dtype == "float32":
                assert gap <= F32_TOL * scale, (shape, gap, scale)
            else:
                assert gap <= 2 * own, (shape, gap, own)


def ttr_init(cfg):
    from repro_torch.models import transformer
    return transformer.build_param_table(cfg).init(
        torch.Generator().manual_seed(0), device="cpu",
        dtype=getattr(torch, cfg.dtype))


def test_elastic_restart_onto_other_meshes(tmp_path):
    """float32, 16 rows in two micro-batches: a run on (2, 4) with a
    checkpoint every step crashes at step 3; restarts from its checkpoint
    on (4, 2), (8, 1) and one device each end within 1e-5 of the
    uninterrupted (2, 4) run, and report their own mesh."""
    _, cfg = _cfgs("granite", "float32")
    shape = ShapeConfig("t", 16, 16, "train", grad_accum=2)
    kw = dict(ckpt_every=1, log_every=0)
    ref = ttrain.train(cfg, shape, 5, None, mesh=_mesh((2, 4)), **kw)
    assert ref["mesh"] == (("data", 2), ("model", 4))
    assert all(M.is_placed(x) for x in tree_leaves(ref["params"]))
    with pytest.raises(HostFailure):
        ttrain.train(cfg, shape, 5, str(tmp_path / "a"),
                     injector=FaultInjector(crash_at=[3]), restarts_left=0,
                     mesh=_mesh((2, 4)), **kw)
    want = tree_leaves((ref["params"], ref["opt"]))
    for shp in ((4, 2), (8, 1), (1, 1)):
        d = tmp_path / f"m{shp[0]}x{shp[1]}"
        shutil.copytree(tmp_path / "a", d)
        out = ttrain.train(cfg, shape, 5, str(d), mesh=_mesh(shp),
                           device="cpu", **kw)
        assert out["final_step"] == 5 and len(out["losses"]) == 2
        assert out["mesh"] == (("data", shp[0]), ("model", shp[1]))
        for a, b in zip(tree_leaves((out["params"], out["opt"])), want):
            assert _rel_max(a, b) <= F32_TOL
        np.testing.assert_allclose(out["losses"], ref["losses"][3:],
                                   rtol=F32_TOL)
