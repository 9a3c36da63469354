"""The hybrid (Hymba-1.5B) and VLM (Qwen2-VL-7B) families over a (data,
model) mesh (`distributed.spmd` through `launch.steps.plan` and
`launch.train`), on ``[cpu] * n`` meshes, against the port's unsplit
steps and the JAX package's unsharded step under plain ``jax.jit``.

Hymba: each model shard runs its query heads' attention (K3) and the
same heads of the SSM bank (K4, `models.ssm.ssm_heads`); ``wo`` and
``out_proj`` are row-parallel float32 partials summed in one all-reduce,
each rounded once, before the fuse. Its cache holds per layer a ring of
W_i slots (the window of 16 in SWA layers, the whole length in global
ones) beside the SSM state. Qwen2-VL: dense blocks over M-RoPE positions
(B, S, 3), vision embeds in place of the first positions, both placed
with the batch's rows.

Bars, those of `tests/test_torch_lm_mesh_steps.py`: float32 compute,
within 1e-5 (relative L2) of the unsplit step and 1e-4 of the reference;
bf16 compute, every parameter within twice the reference's own
bf16-vs-float32 error. The VLM's key bias is held per element at 2 lr
instead of by its relative L2: its gradient is zero in exact arithmetic
(a bias on every key shifts each query's scores alike), so its float32
values are rounding noise, and AdamW's first update g / (|g| + 1e-8)
turns each into about +-lr whatever its size; its moments keep their
bars. Serving in float32: the prefill's logits within 1e-5 of their
largest, each element of its bf16 cache within one bf16 rounding, the
SSM state within 1e-5 per head block. The decode steps start from the
unsplit prefill's cache, int8 where the preset has it and else in
float32: a new key or value that the split computes in another
summation order may round to the neighbouring bf16 value (2^-8
relative), which moves the next logits by ~1e-4, so the steps' own
arithmetic is held over float32 slots at 1e-5, and the bf16 slots the
mesh prefill writes are held against the reference's decode at
`CACHE_TOL`.
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
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import decoding, ssm, transformer
from repro_torch.models.layers import params_from_numpy, tree_leaves
from repro_torch.models.layers import tree_map
from repro_torch.optim import adamw
from test_torch_families import family_batch

CPU = torch.device("cpu")
F32_TOL = 1e-5
F32_REF = 1e-4
# float32 compute over the bf16 cache, against the reference
# (`tests/test_torch_lm.py`): a k or v rounded to a neighbouring bf16
# value moves the logits by ~1e-3
CACHE_TOL = 2e-2
B = 8
S_TRAIN = 32
CONFIGS = {
    # H=4, KV=2: two heads a shard on m=2, one on m=4 (two shards share
    # a KV head); the SWA layer's window of 16 is shorter than S
    "hymba": ("hymba-1.5b", {}),
    # 16 heads, 4 KV heads: the heads split in storage too
    "hymba-h16": ("hymba-1.5b", dict(n_heads=16, n_kv_heads=4,
                                     head_dim=4)),
    # H=12, KV=3: on m=2 and m=4 the group mapping keeps every head on
    # every shard, while the cache cuts the SSM state by H
    "hymba-h12": ("hymba-1.5b", dict(n_heads=12, n_kv_heads=3,
                                     head_dim=4)),
    "qwen2-vl": ("qwen2-vl-7b", {}),
    # G = 7, as Qwen2-VL-7B's 28 heads over 4 KV heads: one KV head a
    # shard on m=4
    "qwen2-vl-g7": ("qwen2-vl-7b", dict(n_heads=28, n_kv_heads=4,
                                        head_dim=8,
                                        mrope_sections=(2, 1, 1))),
}
TRAINED = ["hymba", "hymba-h16", "qwen2-vl", "qwen2-vl-g7"]
TRAIN = [("baseline", (2, 2)), ("tp", (2, 2)), ("tp", (1, 4)),
         ("cp", (2, 2)), ("cp", (1, 4))]
SERVE = [("serve8", (2, 2)), ("kv8", (1, 4)), ("cp", (2, 2)),
         ("cp", (1, 4))]
# decode steps after a prompt of S: at 64 + 4 the global layers' 68 slots
# split over m = 2 and 4; at 60 + 3 (S % 16 != 0 in the SWA layers) their
# 63 slots are whole on every shard
NEW = {64: 4, 60: 3}
BIAS_K = "blocks/attn/bk"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The module's tensors are a few KB: run torch's CPU ops on one
    thread (restored after the module), so that the many small ops of a
    mesh's positions do not contend for the cores with the other test
    workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), [CPU] * int(np.prod(shape)))


def _cfgs(key, dtype="float32"):
    name, over = CONFIGS[key]
    over = dict(over, dtype=dtype)
    return (dataclasses.replace(J_ARCHS[name], **over),
            dataclasses.replace(T_ARCHS[name], **over))


def _params(key, seed):
    jcfg, tcfg = _cfgs(key)
    jp = jtr.build_param_table(jcfg).init(jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _inputs(cfg, S, seed):
    """Tokens and the VLM's stub inputs (`family_batch`), the vision
    embeds rounded to bf16, the type the plan places them in."""
    batch = family_batch(cfg, B, S, seed)
    if "vision_embeds" in batch:
        batch["vision_embeds"] = torch.from_numpy(
            batch["vision_embeds"]).bfloat16().float().numpy()
    return batch


def _train_batch(cfg, S, seed):
    batch = _inputs(cfg, S, seed)
    toks = batch["tokens"]
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)],
                            1)
    for r in range(B):               # rows with different label counts
        labels[r, :(0, 5, 2, 9)[r % 4]] = -1
    batch["labels"] = labels
    return batch


def _paths(tree, prefix=""):
    """Leaf paths in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}/{k}" if prefix else k)]
    return [prefix]


def _whole(x):
    return x.gather(CPU) if M.is_placed(x) else x


def _rel_l2(a, b) -> float:
    a = _whole(a).float().numpy()
    b = _whole(b).float().numpy() if isinstance(b, torch.Tensor) \
        or M.is_placed(b) else np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _max_abs(a, b) -> float:
    a = _whole(a).float().numpy()
    b = _whole(b).float().numpy() if isinstance(b, torch.Tensor) \
        or M.is_placed(b) else np.asarray(b, np.float32)
    return float(np.abs(a - b).max())


def _recorded_kernel_calls(monkeypatch):
    """Record every K3 call's (query heads, KV heads, Sq, Sk) and every K4
    call's head count."""
    seen = {"k3": [], "k4": []}
    fa, scan = ops.flash_attention, ops.ssm_scan

    def k3(q, k, v, *, causal=True):
        seen["k3"].append((q.shape[1], k.shape[1], q.shape[2], k.shape[2]))
        return fa(q, k, v, causal=causal)

    def k4(a, b, y0):
        seen["k4"].append(a.shape[1])
        return scan(a, b, y0)
    monkeypatch.setattr(ops, "flash_attention", k3)
    monkeypatch.setattr(ops, "ssm_scan", k4)
    return seen


def _port_step(cfg, shape, params, batch, mesh=None, preset=None):
    """The port's step on a copy of ``params``: unsplit, or `plan`'s step
    over ``mesh`` by ``preset``."""
    params = tree_map(torch.clone, params)
    if mesh is None:
        specs = tsteps.input_specs(cfg, shape)
        tb = {k: torch.from_numpy(v).to(specs[k][1])
              for k, v in batch.items()}
        fn = tsteps.make_train_step(cfg, shape)
        p, st, m = fn(params, adamw.init(params), tb)
        return p, st, {k: float(v) for k, v in m.items()}
    fn, _s, ins, outs, _d = tsteps.plan(cfg, shape, mesh,
                                        tsteps.resolve_rules(preset))
    P = M.place_tree(params, ins[0])
    P, O, m = fn(P, tsteps.init_opt(P), batch)
    for x, pl in zip(tree_leaves(P), tree_leaves(outs[0])):
        assert x.spec == pl.spec
    return P, O, {k: float(v) for k, v in m.items()}


def _ref_step(jcfg, jp, batch):
    fn = jax.jit(jsteps.make_train_step(
        jcfg, JShape("t", S_TRAIN, B, "train", grad_accum=2)))
    jp2, st, m = fn(jp, jadamw.init(jp),
                    {k: jnp.asarray(v) for k, v in batch.items()})
    return jp2, st, {k: float(v) for k, v in m.items()}


SHAPE_T = ShapeConfig("t", S_TRAIN, B, "train", grad_accum=2)


@functools.lru_cache(maxsize=None)
def _float32_runs(key):
    """(config, reference params, port params, batch, the unsplit port
    step, the reference's jitted step) in float32, once per config."""
    jcfg, tcfg = _cfgs(key)
    jp, tp = _params(key, 1)
    batch = _train_batch(tcfg, S_TRAIN, seed=3)
    return (tcfg, jp, tp, batch, _port_step(tcfg, SHAPE_T, tp, batch),
            _ref_step(jcfg, jp, batch))


def _held_leaves(got, unsplit, ref, lr):
    """Every parameter and moment of ``got`` (placed) within 1e-5 of
    ``unsplit`` and 1e-4 of ``ref`` (relative L2); the key bias's
    parameter per element within 2 lr of both (module docstring)."""
    (p2, s2), (p1, s1), (jp3, s3) = got, unsplit, ref
    for path, a, b, c in zip(_paths(p1), tree_leaves(p2), tree_leaves(p1),
                             jax.tree.leaves(jp3)):
        if path == BIAS_K:
            assert _max_abs(a, b) <= 2 * lr and _max_abs(a, c) <= 2 * lr
            continue
        assert _rel_l2(a, b) <= F32_TOL, (path, _rel_l2(a, b))
        assert _rel_l2(a, c) <= F32_REF, (path, _rel_l2(a, c))
    for a, b, c in zip(tree_leaves((s2.m, s2.v)), tree_leaves((s1.m, s1.v)),
                       jax.tree.leaves((s3.m, s3.v))):
        assert _rel_l2(a, b) <= F32_TOL
        assert _rel_l2(a, c) <= F32_REF


def _shard_heads(lay, cp):
    """The (query heads, KV heads) of each shard's K3 calls: its own, or
    every head under cp."""
    cfg = lay.cfg
    if cp:
        return {(cfg.n_heads, cfg.n_kv_heads)}
    return {(hi - lo, lay.kv_heads(i)[1] - lay.kv_heads(i)[0])
            for i, (lo, hi) in ((i, lay.heads(i)) for i in range(lay.n))}


@pytest.mark.parametrize("key", TRAINED)
@pytest.mark.parametrize("preset,shape", TRAIN)
def test_float32_step_matches_unsplit_and_reference(key, preset, shape,
                                                    monkeypatch):
    """grad_accum 2 on 8 rows of ragged labels, 32 positions: loss, grad
    norm, lr, every parameter and moment within 1e-5 of the unsplit port
    step and 1e-4 of the reference's (the key bias per element, module
    docstring). Each shard calls K3 at its heads (every head under cp, at
    its block's queries) and, for Hymba, K4 at its heads in every layer,
    position and micro-batch, over the whole sequence under cp too."""
    tcfg, _jp, tp, batch, (p1, s1, m1), (jp3, s3, m3) = _float32_runs(key)
    mesh = _mesh(shape)
    seen = _recorded_kernel_calls(monkeypatch)
    p2, s2, m2 = _port_step(tcfg, SHAPE_T, tp, batch, mesh, preset)
    for k in ("loss", "grad_norm", "lr", "moe_aux"):
        assert abs(m2[k] - m1[k]) <= F32_TOL * max(abs(m1[k]), 1e-30), k
        np.testing.assert_allclose(m2[k], m3[k], rtol=F32_REF, atol=1e-7)
    _held_leaves((p2, s2), (p1, s1), (jp3, s3), m2["lr"])
    lay = spmd.Layout(tcfg, mesh, cp=preset == "cp")
    cp = lay.cp_on(S_TRAIN)
    assert seen["k3"]
    assert {h[:2] for h in seen["k3"]} == _shard_heads(lay, cp)
    if cp:
        blk = S_TRAIN // lay.m
        assert {h[2] for h in seen["k3"]} == {blk}
    else:
        assert {h[2:] for h in seen["k3"]} == {(S_TRAIN, S_TRAIN)}
    if tcfg.family == "hybrid":
        heads = {hi - lo for lo, hi in map(lay.heads, range(lay.n))}
        assert {d // (B // 2 // mesh.shape["data"]) for d in seen["k4"]} \
            == heads
        assert len(seen["k4"]) == 2 * mesh.size * tcfg.n_layers
    else:
        assert not seen["k4"]


def test_float32_step_where_attention_computes_every_head():
    """H=12, KV=3 on (2, 2): the group mapping keeps every attention and
    SSM head on every shard (no row-parallel product but the MLP's); the
    tp step within 1e-5 of the unsplit port step and 1e-4 of the
    reference's, loss, grad norm, every parameter and moment."""
    tcfg, _jp, tp, batch, (p1, s1, m1), (jp3, s3, m3) = _float32_runs(
        "hymba-h12")
    assert not spmd.Layout(tcfg, _mesh((2, 2))).split_heads
    p2, s2, m2 = _port_step(tcfg, SHAPE_T, tp, batch, _mesh((2, 2)), "tp")
    for k in ("loss", "grad_norm"):
        assert abs(m2[k] - m1[k]) <= F32_TOL * abs(m1[k]), k
        np.testing.assert_allclose(m2[k], m3[k], rtol=F32_REF, atol=1e-7)
    _held_leaves((p2, s2), (p1, s1), (jp3, s3), m2["lr"])


@functools.lru_cache(maxsize=None)
def _bf16_ref(key):
    jcfg, _ = _cfgs(key, "bfloat16")
    jp, _ = _params(key, 1)
    return _ref_step(jcfg, jp, _float32_runs(key)[3])


@pytest.mark.parametrize("key,shape", [("hymba-h16", (2, 2)),
                                       ("qwen2-vl-g7", (1, 4))])
def test_bf16_step_within_the_references_bf16_error(key, shape):
    """bf16 compute, the tp preset: the hybrid family (its SSM and
    attention partials summed in one all-reduce, each rounded once) and
    the VLM at G = 7 (one KV head a shard on m = 4). Every parameter no
    further from the reference's bf16 step than twice that step is from
    its float32 step (the reference's float32 step is the float32
    test's)."""
    _, tcfg = _cfgs(key, "bfloat16")
    _c, _jp, tp, batch, _u, (j32, _, _) = _float32_runs(key)
    jb, _, mb = _bf16_ref(key)
    p, _, m = _port_step(tcfg, SHAPE_T, tp, batch, _mesh(shape), "tp")
    assert abs(m["loss"] - mb["loss"]) < 5e-3
    ref_err = max(_rel_l2(torch.from_numpy(np.array(a, np.float32)), b)
                  for a, b in zip(jax.tree.leaves(jb),
                                  jax.tree.leaves(j32)))
    err = max(_rel_l2(a, b) for a, b in zip(tree_leaves(p),
                                            jax.tree.leaves(jb)))
    assert ref_err > 0 and err <= 2 * ref_err, (err, ref_err)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _torch_batch(cfg, batch, kind="prefill"):
    specs = tsteps.input_specs(cfg, ShapeConfig("p", 8, B, kind))
    return {k: torch.from_numpy(v).to(specs[k][1]) for k, v in batch.items()
            if k in specs}


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


@functools.lru_cache(maxsize=None)
def _unsplit_serving(key, S, int8):
    """The unsplit float32 run: (params, prompt batch, fed tokens, the
    prefill's last logits and cache of S + T slots (int8 where asked,
    else its slots in float32: module docstring), each decode step's
    logits, the cache after them)."""
    _, tcfg = _cfgs(key)
    _jp, tp = _params(key, 2)
    T = NEW[S]
    batch = _inputs(tcfg, S, seed=5)
    feed = [torch.from_numpy(f) for f in np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (T, B, 1)).astype(np.int32)]
    last, cache = decoding.prefill(tcfg, tp, _torch_batch(tcfg, batch),
                                   max_len=S + T)
    if int8:
        cache = decoding.quantize_cache(tcfg, cache)
    else:
        cache = tree_map(lambda t: t.float() if t.is_floating_point()
                         else t, cache)
    start = _clone(cache)
    logits = []
    for t, tok in enumerate(feed):
        lg, cache = decoding.decode_step(tcfg, tp, cache, tok, S + t)
        logits.append(lg)
    return tp, batch, feed, last, start, logits, cache


def _cache_close(got, want):
    """Each leaf of a gathered mesh cache against the unsplit one: k and v
    within one bf16 rounding (int8 values within 1, scales within one bf16
    rounding), positions equal, the SSM state within 1e-5 of each head
    block's (a position's piece against the same block of ``want``)."""
    if "layers" in want:
        for g, w in zip(got["layers"], want["layers"]):
            _cache_close(g, w)
        x = got["ssm"]
        for piece, blk in zip(x.pieces, x.blocks()):
            ref = want["ssm"][tuple(slice(lo, hi) for lo, hi in blk)]
            assert _rel_l2(piece, ref) <= F32_TOL
        return
    for name, w in want.items():
        g = _whole(got[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "pos":
            assert torch.equal(g, w)
        elif w.dtype == torch.int8:
            assert int((g.int() - w.int()).abs().max()) <= 1
        elif w.dtype == torch.float32:
            assert _rel_l2(g, w) <= F32_TOL, name
        else:
            assert torch.allclose(g.float(), w.float(), rtol=2 ** -7,
                                  atol=1e-6), name


@pytest.mark.parametrize("key", sorted(CONFIGS))
@pytest.mark.parametrize("S", sorted(NEW))
@pytest.mark.parametrize("preset,shape", SERVE)
def test_float32_prefill_and_decode_match_unsplit(key, S, preset, shape,
                                                  monkeypatch):
    """8 prompts of S (vision embeds and M-RoPE positions for the VLM):
    the plan's prefill step's logits within 1e-5 of the unsplit
    prefill's, the cache of S + T slots (`spmd.prefill`) per element
    within one bf16 rounding and its SSM state per head block within
    1e-5; K3 at each shard's heads (the VLM every layer, Hymba its global
    layers and, under cp, the SWA layer's blocks inside the window) and
    K4 at each shard's heads. Then T decode steps of the plan, from the
    unsplit prefill's cache placed on the mesh (int8 under serve8 and kv8
    for the VLM, the hybrid cache having none; else float32 slots), each
    step's logits within 1e-5 and the cache after them as the
    prefill's."""
    _, tcfg = _cfgs(key)
    int8 = preset in ("serve8", "kv8") and tcfg.family != "hybrid"
    tp, batch, feed, last, start, logits, end = _unsplit_serving(key, S,
                                                                 int8)
    T, mesh = NEW[S], _mesh(shape)
    rules = tsteps.resolve_rules(preset)
    pfn, _s, pins, pouts, _d = tsteps.plan(
        tcfg, ShapeConfig("p", S, B, "prefill"), mesh, rules)
    P = M.place_tree(tp, pins[0])
    seen = _recorded_kernel_calls(monkeypatch)
    lg, _c = pfn(P, batch)
    assert lg.spec == pouts[0].spec
    scale = float(last.abs().max())
    assert _max_abs(lg, last) <= F32_TOL * scale
    lay = spmd.Layout(tcfg, mesh, cp=preset == "cp")
    assert {h[:2] for h in seen["k3"]} == _shard_heads(lay, lay.cp_on(S))
    if tcfg.family == "hybrid":
        heads = {hi - lo for lo, hi in map(lay.heads, range(lay.n))}
        rows = B // mesh.shape["data"]
        assert {d // rows for d in seen["k4"]} == heads
        assert len(seen["k4"]) == mesh.size * tcfg.n_layers
    _, want = decoding.prefill(tcfg, tp, _torch_batch(tcfg, batch),
                               max_len=S + T)
    pb = tsteps.place_batch(mesh, tcfg, ShapeConfig("p", S, B, "prefill"),
                            batch)
    _, cache = spmd.prefill(tcfg, mesh, P, pb, max_len=S + T,
                            cp=preset == "cp")
    _cache_close(cache, want)
    dfn, _s, dins, douts, _d = tsteps.plan(
        tcfg, ShapeConfig("d", S + T, B, "decode"), mesh, rules)
    P = M.place_tree(tp, dins[0])
    cache = M.place_tree(_clone(start), dins[1])
    for t, tok in enumerate(feed):
        lg, cache = dfn(P, cache, tok, S + t)
        assert lg.spec == douts[0].spec
        assert _max_abs(lg, logits[t]) <= F32_TOL * float(
            logits[t].abs().max()), t
    _cache_close(cache, end)


@functools.lru_cache(maxsize=None)
def _ref_serving(key):
    """The reference's jitted prefill (max_len 68) and decode steps on the
    64-token prompts and fed tokens of `_unsplit_serving`."""
    jcfg, _ = _cfgs(key)
    jp, _ = _params(key, 2)
    _tp, batch, feed, *_ = _unsplit_serving(key, 64, False)
    last, cache = jax.jit(lambda p, b: jdec.prefill(jcfg, p, b, max_len=68))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    step = jax.jit(lambda p, c, t, s: jdec.decode_step(jcfg, p, c, t, s))
    out = []
    for t, tok in enumerate(feed):
        lg, cache = step(jp, cache, jnp.asarray(tok.numpy()),
                         jnp.int32(64 + t))
        out.append(np.asarray(lg, np.float32))
    return np.asarray(last, np.float32), out


@pytest.mark.parametrize("key", TRAINED)
@pytest.mark.parametrize("preset,shape", [("tp", (2, 2)), ("cp", (1, 4))])
def test_mesh_serving_matches_the_reference(key, preset, shape):
    """64-token prompts (S % W = 0, where the reference's ring is the
    port's): the mesh prefill's last logits within 1e-4 of the
    reference's jitted prefill, and 4 decode steps from the mesh
    prefill's own bf16 cache within CACHE_TOL of the reference's."""
    _, tcfg = _cfgs(key)
    tp, batch, feed, *_ = _unsplit_serving(key, 64, False)
    jlast, jlogits = _ref_serving(key)
    mesh = _mesh(shape)
    fn, _s, ins, _o, _d = tsteps.plan(
        tcfg, ShapeConfig("d", 68, B, "decode"), mesh,
        tsteps.resolve_rules(preset))
    P = M.place_tree(tp, ins[0])
    pb = tsteps.place_batch(mesh, tcfg, ShapeConfig("p", 64, B, "prefill"),
                            batch)
    lg, cache = spmd.prefill(tcfg, mesh, P, pb, max_len=68,
                             cp=preset == "cp")
    assert _max_abs(lg, jlast) <= F32_REF * float(np.abs(jlast).max())
    for t, tok in enumerate(feed):
        lg, cache = fn(P, cache, tok, 64 + t)
        np.testing.assert_allclose(_whole(lg).numpy(), jlogits[t],
                                   rtol=CACHE_TOL, atol=CACHE_TOL)


def _chained(cfg, params, batch, feed, S, mesh=None, preset=None):
    """Prefill and decode steps fed ``feed``, unsplit or over ``mesh`` by
    ``preset``'s plan; each logits as float32 on the CPU."""
    T = len(feed)
    if mesh is None:
        last, cache = decoding.prefill(cfg, params, _torch_batch(cfg, batch),
                                       max_len=S + T)
        cache = (decoding.quantize_cache(cfg, cache)
                 if cfg.family != "hybrid" else cache)
        out = [last.float()]
        for t, tok in enumerate(feed):
            lg, cache = decoding.decode_step(cfg, params, cache, tok, S + t)
            out.append(lg[:, 0].float())
        return out
    fn, _s, ins, _o, _d = tsteps.plan(cfg, ShapeConfig("d", S + T, B,
                                                       "decode"), mesh,
                                      tsteps.resolve_rules(preset))
    P = M.place_tree(params, ins[0])
    pb = tsteps.place_batch(mesh, cfg, ShapeConfig("p", S, B, "prefill"),
                            batch)
    last, cache = spmd.prefill(cfg, mesh, P, pb, max_len=S + T)
    if cfg.family != "hybrid":
        cache = spmd.quantize_cache(cfg, cache)
    out = [last.gather(CPU).float()]
    for t, tok in enumerate(feed):
        lg, cache = fn(P, cache, tok, S + t)
        out.append(lg.gather(CPU)[:, 0].float())
    return out


@pytest.mark.parametrize("key", ["hymba-h16", "qwen2-vl-g7"])
def test_bf16_serve8_within_twice_the_unsplit_bf16_gap(key):
    """bf16 compute, serve8 on (1, 4) (the VLM's cache int8, Hymba's
    bf16): the prefill's and every step's logits within twice the unsplit
    bf16 run's own gap to its float32 run at the same prompts and fed
    tokens."""
    _, c16 = _cfgs(key, "bfloat16")
    _, c32 = _cfgs(key)
    tp, batch, feed, *_ = _unsplit_serving(key, 64, False)
    p16 = tree_map(lambda t: t.bfloat16(), tp)
    want = _chained(c16, p16, batch, feed, 64)
    ref32 = _chained(c32, tree_map(lambda t: t.float(), p16), batch, feed,
                     64)
    own = max(float((a - b).abs().max()) for a, b in zip(want, ref32))
    got = _chained(c16, p16, batch, feed, 64, _mesh((1, 4)), "serve8")
    gap = max(float((a - b).abs().max()) for a, b in zip(got, want))
    assert own > 0 and gap <= 2 * own, (gap, own)


# --------------------------------------------------------------------------
# the head bank, the cache's placement, the training loop
# --------------------------------------------------------------------------

def test_ssm_head_bank_cuts_by_heads():
    """`ssm.ssm_heads` on one block of heads' weights (in_proj and
    gate_proj columns, dt_proj columns, a_log and d_skip entries) gives
    that block's columns of the whole bank's y and its heads' state;
    `ssm_scan` is the whole bank through ``out_proj``, bit for bit."""
    _, cfg = _cfgs("hymba-h16")
    _jp, tp = _params("hymba-h16", 3)
    p = transformer.layer_params(tp["blocks"], 0)["ssm"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32))
    y, st = ssm.ssm_heads(cfg, p, x)
    out, st2 = ssm.ssm_scan(cfg, p, x)
    assert torch.equal(out, y @ p["out_proj"]) and torch.equal(st, st2)
    Dh = cfg.resolved_head_dim
    lo, hi = 4, 8
    cut = dict(p, in_proj=p["in_proj"][:, lo * Dh:hi * Dh],
               gate_proj=p["gate_proj"][:, lo * Dh:hi * Dh],
               dt_proj=p["dt_proj"][:, lo:hi], a_log=p["a_log"][lo:hi],
               d_skip=p["d_skip"][lo:hi])
    yc, stc = ssm.ssm_heads(cfg, cut, x)
    torch.testing.assert_close(yc, y[..., lo * Dh:hi * Dh], rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(stc, st[:, lo:hi], rtol=1e-6, atol=1e-7)


def test_hybrid_cache_placement_is_the_references():
    """The plan's hybrid cache placements: each layer's slots over
    "model" where its W_i divides, the SSM state by H where H divides;
    the decode step reads the state at the shard's heads."""
    _, cfg = _cfgs("hymba-h12")
    mesh = _mesh((2, 2))
    _f, _s, ins, _o, _d = tsteps.plan(cfg, ShapeConfig("d", 63, B,
                                                       "decode"), mesh)
    csh = ins[1]
    assert csh["ssm"].spec == M.P(None, "data", "model", None, None)
    assert csh["layers"][0]["k"].spec == M.P("data", None, None, None)
    assert csh["layers"][1]["k"].spec == M.P("data", "model", None, None)
    assert csh["layers"][1]["pos"].spec == M.P("data", "model")


@pytest.mark.parametrize("key", ["hymba", "qwen2-vl"])
def test_train_on_a_mesh_matches_one_device(key):
    """`launch.train` over (2, 2) (the VLM's vision embeds and positions
    from the token pipeline, placed with the rows) against the same run
    on one device, float32, 2 steps: the losses and every moment within
    1e-5 (relative L2); every parameter per element within 1e-5 of its
    leaf's largest value plus 1e-4 of the leaf's largest change over the
    run (a leaf that starts at zero, as ``a_log``, is all AdamW update,
    whose ratio m / sqrt(v) magnifies the moments' rounding where two
    steps' gradients cancel), the key bias within twice its largest
    change (module docstring)."""
    _, cfg = _cfgs(key)
    shape = ShapeConfig("t", 16, B, "train", grad_accum=2)
    one = ttrain.train(cfg, shape, 2, None, mesh=_mesh((1, 1)),
                       log_every=0, device="cpu")
    got = ttrain.train(cfg, shape, 2, None, mesh=_mesh((2, 2)), log_every=0)
    assert got["mesh"] == (("data", 2), ("model", 2))
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=F32_TOL)
    start, _ = ttrain.build_state(cfg, "cpu")
    for path, a, b, b0 in zip(_paths(start), tree_leaves(got["params"]),
                              tree_leaves(one["params"]),
                              tree_leaves(start)):
        moved = float((b - b0).abs().max())
        bar = (2 * moved if path == BIAS_K else
               F32_TOL * float(b.abs().max()) + F32_REF * moved)
        assert _max_abs(a, b) <= bar, path
    for a, b in zip(tree_leaves((got["opt"].m, got["opt"].v)),
                    tree_leaves((one["opt"].m, one["opt"].v))):
        assert _rel_l2(a, b) <= F32_TOL
