"""The mixture-of-experts family over a (data, model) mesh: expert
parallelism in `distributed.spmd` (the experts split over "model", the
routing replicated, the capacity bookkeeping over the whole batch), the
sharded training steps ("baseline", "tp", `grad_accum` 1 and 2) and the
int8 serving presets ("kv8", "serve8"), on ``[cpu] * n`` meshes against the port's unsplit
steps and the JAX package's unsharded step under plain ``jax.jit``.

Bars, those of `tests/test_torch_lm_mesh_steps.py`: float32 compute, the
sharded step within 1e-5 relative of the unsplit one (another summation
order of the same float32 products) and within `F32_REF` (1e-4 relative
L2) of the reference; bf16 compute, the loss within the reference's own
5e-3 between its presets and every parameter within twice the
reference's own bf16-vs-float32 error. The set of assignments that
capacity drops is the unsplit run's, bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED_ARCHS as J_ARCHS
from repro.configs.base import ShapeConfig as JShape
from repro.launch import steps as jsteps
from repro.models import decoding as jdec
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro_torch.configs import REDUCED_ARCHS as T_ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import meshes as M
from repro_torch.distributed import spmd
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import decoding, moe, transformer
from repro_torch.models.layers import params_from_numpy, tree_leaves, tree_map
from repro_torch.optim import adamw

CPU = torch.device("cpu")
F32_TOL = 1e-5
F32_REF = 1e-4
BF16_LOSS = 5e-3
NAMES = ["moonshot-v1-16b-a3b", "mixtral-8x7b"]
MESHES = [(2, 2), (1, 4), (4, 1)]
B, S = 8, 16


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     [CPU] * int(np.prod(shape)))


def _cfgs(name, dtype, **over):
    over = dict(over, dtype=dtype)
    return (dataclasses.replace(J_ARCHS[name], **over),
            dataclasses.replace(T_ARCHS[name], **over))


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)],
                            1)
    for r in range(B):               # rows with different label counts
        labels[r, :(0, 5, 2, 9)[r % 4]] = -1
    return {"tokens": toks, "labels": labels}


def _whole(x):
    return x.gather(CPU) if M.is_placed(x) else x


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
    over ``mesh`` by ``preset``."""
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
    for x, pl in zip(tree_leaves(P), tree_leaves(outs[0])):
        assert x.spec == pl.spec
    return P, O, {k: float(v) for k, v in m.items()}


@functools.lru_cache(maxsize=None)
def _float32_runs(name, accum):
    """(config, port params, batch, the unsplit port step, the reference's
    step) in float32, once per config and accumulation."""
    jcfg, tcfg = _cfgs(name, "float32")
    jp = jtr.build_param_table(jcfg).init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(tcfg, seed=3)
    unsplit = _port_step(tcfg, ShapeConfig("t", S, B, "train",
                                           grad_accum=accum), tp, batch)
    ref = _ref_step(jcfg, JShape("t", S, B, "train", grad_accum=accum), jp,
                    batch)
    return tcfg, tp, batch, unsplit, ref


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("preset", ["baseline", "tp"])
@pytest.mark.parametrize("name", NAMES)
def test_float32_moe_step_matches_unsplit_and_reference(name, preset, shape,
                                                        accum):
    """8 rows of ragged labels, 16 tokens each, one or two micro-batches:
    loss, load-balancing loss (the micro-batch's with one, 0 with two, as
    the reference reports it), grad norm, lr, every parameter and moment
    within 1e-5 (relative L2) of the unsplit port step and within 1e-4 of
    the reference's. On a model axis of 2 or 4 the reduced configs' 4
    experts split over it."""
    tcfg, tp, batch, (p1, s1, m1), (jp3, s3, m3) = _float32_runs(name,
                                                                 accum)
    lay = spmd.Layout(tcfg, _mesh(shape))
    assert lay.split_experts == (shape[1] > 1)
    shape_t = ShapeConfig("t", S, B, "train", grad_accum=accum)
    p2, s2, m2 = _port_step(tcfg, shape_t, tp, batch, _mesh(shape), preset)
    assert m1["moe_aux"] > 0 if accum == 1 else m1["moe_aux"] == 0
    for k in ("loss", "grad_norm", "lr", "moe_aux"):
        assert abs(m2[k] - m1[k]) <= F32_TOL * max(abs(m1[k]), 1e-30), k
        np.testing.assert_allclose(m2[k], m3[k], rtol=F32_REF, atol=1e-7)
    for a, b, c in zip(tree_leaves((p2, s2.m, s2.v)),
                       tree_leaves((p1, s1.m, s1.v)),
                       jax.tree.leaves((jp3, s3.m, s3.v))):
        assert _rel_l2(a, b) <= F32_TOL, (_rel_l2(a, b), a)
        assert _rel_l2(a, c) <= F32_REF


@functools.lru_cache(maxsize=None)
def _bf16_runs(name):
    """(config, port params, batch, the reference's bf16 step, its float32
    step), grad_accum 2, once per config: the float32 step, parameters
    and batch are `_float32_runs`'."""
    jcfg, tcfg = _cfgs(name, "bfloat16")
    jp = jtr.build_param_table(jcfg).init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jshape = JShape("t", S, B, "train", grad_accum=2)
    _, _, batch, _, ref32 = _float32_runs(name, 2)
    return (tcfg, tp, batch, _ref_step(jcfg, jshape, jp, batch), ref32)


@pytest.mark.parametrize("preset", ["baseline", "tp"])
@pytest.mark.parametrize("name", NAMES)
def test_bf16_moe_step_within_the_references_bf16_error(name, preset):
    """bf16 compute over (2, 2): the loss within 5e-3 of the reference's
    bf16 step, each parameter no further from it than twice the
    reference's bf16 step is from its float32 step."""
    tcfg, tp, batch, (jb, _, mb), (j32, _, _) = _bf16_runs(name)
    p, _, m = _port_step(tcfg, ShapeConfig("t", S, B, "train",
                                           grad_accum=2), tp, batch,
                         _mesh((2, 2)), preset)
    assert abs(m["loss"] - mb["loss"]) < BF16_LOSS
    ref_err = max(_rel_l2(torch.from_numpy(np.array(a, np.float32)), b)
                  for a, b in zip(jax.tree.leaves(jb),
                                  jax.tree.leaves(j32)))
    err = max(_rel_l2(a, b) for a, b in zip(tree_leaves(p),
                                            jax.tree.leaves(jb)))
    assert ref_err > 0 and err <= 2 * ref_err, (err, ref_err)


# --------------------------------------------------------------------------
# capacity: the dropped assignments
# --------------------------------------------------------------------------

def _recording(monkeypatch):
    """Record every `moe.place` call's (idx, keep) as (T, k) tensors: the
    unsplit layer calls it through `moe.route`, the mesh's once per
    position."""
    seen = []
    real = moe.place

    def place(ch, C, before=None):
        r = real(ch, C, before)
        seen.append((r.idx.clone(), r.keep.view(r.idx.shape).clone()))
        return r
    monkeypatch.setattr(moe, "place", place)
    return seen


def _global_routes(lay, calls, rows_of):
    """The mesh's recorded calls, n positions a layer, as the whole batch's
    (idx, keep) per layer: the model shard 0 positions' rows in the
    batch's order. Each model shard's routing equals shard 0's."""
    n = lay.n
    assert len(calls) % n == 0
    out = []
    for li in range(len(calls) // n):
        per = calls[li * n:(li + 1) * n]
        for i in range(n):
            j = lay.group[i][0]
            assert torch.equal(per[i][0], per[j][0])
            assert torch.equal(per[i][1], per[j][1])
        blocks = {}
        for i in range(n):
            if lay.r(i) == 0:
                blocks.setdefault(rows_of[i], per[i])
        idx = torch.cat([blocks[b][0] for b in sorted(blocks)])
        keep = torch.cat([blocks[b][1] for b in sorted(blocks)])
        out.append((idx, keep))
    return out


@pytest.mark.parametrize("kind,shape", [("train", (2, 2)),
                                        ("prefill", (2, 2)),
                                        ("prefill", (1, 4)),
                                        ("prefill", (4, 1))])
def test_dropped_assignments_are_the_unsplit_runs(kind, shape, monkeypatch):
    """Reduced Moonlight with capacity_factor 1.0 (the reduced configs'
    8.0 drops nothing) in float32: every layer's experts and kept flags
    over the whole batch are bit-equal to the unsplit run's, and capacity
    drops some assignments: the train step's two micro-batches (each data
    position's rows j::2 are micro-batch j's), or a prefill."""
    name = "moonshot-v1-16b-a3b"
    jcfg, tcfg = _cfgs(name, "float32", capacity_factor=1.0)
    jp = jtr.build_param_table(jcfg).init(jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(tcfg, seed=5)
    mesh = _mesh(shape)
    seen = _recording(monkeypatch)
    if kind == "train":
        shape_t = ShapeConfig("t", S, B, "train", grad_accum=2)
        _port_step(tcfg, shape_t, tp, batch)
        want = list(seen)
        seen.clear()
        _port_step(tcfg, shape_t, tp, batch, mesh, "tp")
        rows = [(lo // 2, hi // 2) for lo, hi in (
            M.block_of(mesh, M.data_sharding(mesh, B, 2).spec, (B, S),
                       c)[0] for c in M.positions(mesh))]
    else:
        tok = torch.from_numpy(batch["tokens"])
        decoding.prefill(tcfg, tp, {"tokens": tok})
        want = list(seen)
        seen.clear()
        fn, _s, ins, _o, _d = tsteps.plan(
            tcfg, ShapeConfig("p", S, B, "prefill"), mesh,
            tsteps.resolve_rules("tp"))
        fn(M.place_tree(tp, ins[0]), {"tokens": tok})
        rows = [M.block_of(mesh, M.data_sharding(mesh, B, 2).spec, (B, S),
                           c)[0] for c in M.positions(mesh)]
    got = _global_routes(spmd.Layout(tcfg, mesh), list(seen), rows)
    assert len(got) == len(want)
    dropped = 0
    for (gi, gk), (wi, wk) in zip(got, want):
        assert torch.equal(gi, wi) and torch.equal(gk, wk)
        dropped += int((~wk).sum())
    assert dropped > 0


def test_capacity_and_places_are_the_whole_batchs():
    """`moe.place` with the counts of the rows before: two halves of a
    batch placed on their own with the first half's counts as ``before``
    give the whole batch's places and kept flags."""
    cfg = dataclasses.replace(T_ARCHS["moonshot-v1-16b-a3b"],
                              capacity_factor=1.0)
    g = torch.Generator().manual_seed(0)
    router = torch.randn(cfg.d_model, cfg.n_experts, generator=g)
    xt = torch.randn(40, cfg.d_model, generator=g)
    whole = moe.route(cfg, router, xt)
    C = moe.capacity(cfg, 40)
    a, b = moe.choose(cfg, router, xt[:16]), moe.choose(cfg, router, xt[16:])
    ra, rb = moe.place(a, C), moe.place(b, C, a.counts)
    assert torch.equal(torch.cat([ra.pos, rb.pos]), whole.pos)
    assert torch.equal(torch.cat([ra.keep, rb.keep]), whole.keep)
    assert not bool(whole.keep.all())
    assert torch.equal(a.counts + b.counts, whole.counts)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _serve(cfg, params, tok, feed=None, mesh=None, preset=None):
    """Prefill the prompt ``tok`` with a horizon of S + T slots, quantize
    the cache to int8, and take T decode steps (the unsplit path, or over
    ``mesh`` by ``preset``'s plan), feeding ``feed`` (None: T = 4 greedy
    tokens). Returns (the prefill's logits and each step's, float32 on the
    CPU; the tokens fed)."""
    Bq, Sq = tok.shape
    T = 4 if feed is None else len(feed)
    toks = []

    def pick(out, t):
        nxt = (out[-1].argmax(-1, keepdim=True).int() if feed is None
               else feed[t])
        toks.append(nxt)
        return nxt
    if mesh is None:
        lg, cache = decoding.prefill(cfg, params, {"tokens": tok},
                                     max_len=Sq + T)
        cache = decoding.quantize_cache(cfg, cache)
        out = [lg.float()]
        for t in range(T):
            lg, cache = decoding.decode_step(cfg, params, cache,
                                             pick(out, t), Sq + t)
            out.append(lg[:, 0].float())
        return out, toks
    fn, _s, ins, outs, _d = tsteps.plan(
        cfg, ShapeConfig("d", Sq + T, Bq, "decode"), mesh,
        tsteps.resolve_rules(preset))
    P = M.place_tree(params, ins[0])
    lg, cache = spmd.prefill(cfg, mesh, P, M.place(tok, M.data_sharding(
        mesh, Bq, 2)), max_len=Sq + T)
    cache = spmd.quantize_cache(cfg, cache)
    assert {k: v.spec for k, v in cache.items()} == \
        {k: v.spec for k, v in ins[1].items()}
    out = [lg.gather(CPU).float()]
    for t in range(T):
        lg, cache = fn(P, cache, pick(out, t), Sq + t)
        assert lg.spec == outs[0].spec
        out.append(lg.gather(CPU)[:, 0].float())
    return out, toks


@pytest.mark.parametrize("preset", ["kv8", "serve8"])
@pytest.mark.parametrize("name", NAMES)
def test_int8_serving_matches_the_unsplit_int8_path_and_reference(name,
                                                                  preset):
    """kv8 (baseline-placed weights) and serve8 (TP-placed), the int8
    cache's slots over "model": a prefill of 4 prompts of 8 tokens and 4 decode steps (the unsplit
    run's greedy tokens fed to every run; a decode step's capacity is the
    batch's 4 tokens') over (2, 2), (1, 4) and (4, 1): float32 logits
    within 1e-5 of the unsplit int8 path's (relative to their largest),
    the prefill's within 1e-4 of the reference's jitted prefill; bf16
    within twice the unsplit bf16 path's own gap to its float32 run."""
    rng = np.random.default_rng(11)
    tok_np = rng.integers(0, 256, (4, 8)).astype(np.int32)
    tok = torch.from_numpy(tok_np)
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = _cfgs(name, dtype)
        jp = jtr.build_param_table(jcfg).init(jax.random.PRNGKey(4))
        params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        want, feed = _serve(tcfg, params, tok)
        if dtype == "float32":
            jlg, _ = jax.jit(lambda p, b: jdec.prefill(jcfg, p, b))(
                jp, {"tokens": jnp.asarray(tok_np)})
            ref = np.asarray(jlg, np.float32)
        else:
            _, c32 = _cfgs(name, "float32")
            ref32, _ = _serve(c32, tree_map(lambda t: t.float(), params),
                              tok, feed)
            own = max(float((a - b).abs().max())
                      for a, b in zip(want, ref32))
        for shape in MESHES:
            got, _ = _serve(tcfg, params, tok, feed, _mesh(shape), preset)
            gap = max(float((a - b).abs().max()) for a, b in zip(got, want))
            scale = max(float(w.abs().max()) for w in want)
            if dtype == "float32":
                assert gap <= F32_TOL * scale, (shape, gap, scale)
                assert float(np.abs(got[0].numpy() - ref).max()) <= \
                    F32_REF * float(np.abs(ref).max())
            else:
                assert gap <= 2 * own, (shape, gap, own)


def test_moe_spans_and_expert_pieces_on_the_mesh():
    """Over (1, 4): each position stores only its own experts' rows under
    the tp compute rules (each expert once on the mesh), and a prefill
    runs under the four `moe.SPANS` (a profile splits the layer as on one
    card)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = T_ARCHS["moonshot-v1-16b-a3b"]
    mesh = _mesh((1, 4))
    fn, _s, ins, _o, _d = tsteps.plan(
        cfg, ShapeConfig("p", 8, 2, "prefill"), mesh,
        tsteps.resolve_rules("tp"))
    params = transformer.build_param_table(cfg).init(
        torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.bfloat16)
    P = M.place_tree(params, ins[0])
    lay = spmd.Layout(cfg, mesh)
    for leaf in ("w_gate", "w_up", "w_down"):
        x = P["blocks"]["moe"][leaf]
        assert x.spec[1] == "model"
        for i, piece in enumerate(x.pieces):
            e0, e1 = lay.experts(i)
            assert torch.equal(piece, params["blocks"]["moe"][leaf][:, e0:e1])
    tok = torch.zeros((2, 8), dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(P, {"tokens": tok})
    names = {e.name for e in prof.events()}
    assert set(moe.SPANS) <= names
