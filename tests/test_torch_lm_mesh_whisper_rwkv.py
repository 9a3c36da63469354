"""The encoder-decoder (Whisper large-v3) and attention-free (RWKV-6 3B)
families over a (data, model) mesh (`distributed.spmd` through
`launch.steps.plan` and `launch.train`), on ``[cpu] * n`` meshes, against
the port's unsplit steps and the JAX package's unsharded step under plain
``jax.jit``.

Whisper: the encoder runs over the frames placed with the batch's rows,
each shard at its heads with a full mask (K3) and, under cp, each model
shard's block of the frames over all of them; a decoder layer's cross-
attention takes the shard's query heads and KV heads of its rows'
encoder output, ``xattn/wo`` row-parallel. Its cache adds the cross keys
and values (L, B, Se, KV, D), cut by Se over "model" where it divides.
RWKV-6: each shard runs the time mix's recurrence over its heads,
``w_o`` and the channel mix's ``c_wv`` row-parallel; its cache's state
(L, B, H, Dk, Dv) is cut by H where H divides.

Bars, those of `tests/test_torch_lm_mesh_families.py`: float32 compute,
within 1e-4 (relative L2) of the reference and 1e-5 of the unsplit step,
the moments with each step's global-norm clip scale divided out (RWKV-6's
u_bonus starts at zero, so its gradient at t = 0 passes the group norm's
1/sqrt(eps) and carries nearly all of the grad norm: its rounding moves
the clip scale, which moves every leaf alike); a parameter also within
twice the unsplit step's own gap to the reference where that is larger
(RWKV-6's zero-start mixes, all AdamW update after one step). bf16
compute, every parameter within
twice the reference's own bf16-vs-float32 error. Serving in float32: the
logits within 1e-5 of their largest, each element of the bf16 cache
within one bf16 rounding, RWKV-6's float32 state within 1e-5. The decode
steps start from the unsplit prefill's cache, int8 (the self-attention
ring; the cross keys and values stay bf16) under serve8 and else in
float32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_FULL
from repro.configs import REDUCED_ARCHS as J_ARCHS
from repro.configs.base import ShapeConfig as JShape
from repro.distributed import meshes as jmeshes
from repro.launch import steps as jsteps
from repro.models import decoding as jdec
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro_torch.configs import ARCHS as T_FULL
from repro_torch.configs import REDUCED_ARCHS as T_ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import meshes as M
from repro_torch.distributed import spmd
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import decoding, rwkv, transformer
from repro_torch.models.layers import params_from_numpy, tree_leaves
from repro_torch.models.layers import tree_map
from repro_torch.optim import adamw
from test_torch_families import family_batch

CPU = torch.device("cpu")
F32_TOL = 1e-5
F32_REF = 1e-4
# float32 compute over the bf16 cache, against the reference
# (`tests/test_torch_lm.py`)
CACHE_TOL = 2e-2
B = 8
S_TRAIN = 32
CONFIGS = {
    # H = KV = 4, 16 frames: two heads a shard on m=2, one on m=4; the
    # cross cache cut by Se on both
    "whisper": ("whisper-large-v3", {}),
    # H = KV = 6, 18 frames: on m=4 every shard computes every head and
    # the cross cache is not cut (nor does cp cut the encoder's frames)
    "whisper-h6": ("whisper-large-v3", dict(n_heads=6, n_kv_heads=6,
                                            enc_len=18)),
    "rwkv": ("rwkv6-3b", {}),
    # 6 heads, which split on m=2 only, and 130 ff columns, which m=4
    # does not divide
    "rwkv-h6": ("rwkv6-3b", dict(n_heads=6, d_ff=130)),
}
TRAIN = [("baseline", (2, 2)), ("tp", (2, 2)), ("tp", (1, 4)),
         ("cp", (2, 2)), ("cp", (1, 4))]
SERVE = [("tp", (2, 2)), ("serve8", (1, 4)), ("cp", (2, 2)),
         ("cp", (1, 4))]
PROMPT, NEW = 12, 3


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
    jcfg, _ = _cfgs(key)
    jp = jtr.build_param_table(jcfg).init(jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _inputs(cfg, S, seed):
    """Tokens and Whisper's stub frames (`family_batch`), the frames
    rounded to bf16, the type the plan places them in."""
    batch = family_batch(cfg, B, S, seed)
    if "enc_frames" in batch:
        batch["enc_frames"] = torch.from_numpy(
            batch["enc_frames"]).bfloat16().float().numpy()
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


def _np(x):
    return (_whole(x).float().numpy() if isinstance(x, torch.Tensor)
            or M.is_placed(x) else np.asarray(x, np.float32))


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _max_abs(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


def _recorded_k3(monkeypatch):
    """Every K3 call's (query heads, KV heads, Sq, Sk, causal); K4 calls
    fail the test (neither family scans with it)."""
    seen = []
    fa = ops.flash_attention

    def k3(q, k, v, *, causal=True):
        seen.append((q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                     causal))
        return fa(q, k, v, causal=causal)

    def k4(*_a):
        raise AssertionError("K4 called")
    monkeypatch.setattr(ops, "flash_attention", k3)
    monkeypatch.setattr(ops, "ssm_scan", k4)
    return seen


def _shard_heads(lay):
    """Each shard's (query heads, KV heads) at its own heads."""
    return {(hi - lo, lay.kv_heads(i)[1] - lay.kv_heads(i)[0])
            for i, (lo, hi) in ((i, lay.heads(i)) for i in range(lay.n))}


def _expected_k3(cfg, lay, S):
    """The set of `_recorded_k3` entries of a Whisper forward over S
    decoder positions on ``lay``: the encoder's and the decoder's self-
    attention at the shard's heads (every head on the blocks of a cp
    call), the cross-attention at the shard's heads under every preset
    where S <= Se (K3 takes no more queries than keys; more run plain, as
    on one card)."""
    Se, H, KV = cfg.enc_len, cfg.n_heads, cfg.n_kv_heads
    own = _shard_heads(lay)
    out = set()
    if lay.cp_on(Se):
        out.add((H, KV, Se // lay.m, Se, False))
    else:
        out |= {h + (Se, Se, False) for h in own}
    if lay.cp_on(S):
        blk = S // lay.m
        out |= {(H, KV, blk, (r + 1) * blk, True) for r in range(lay.m)}
    else:
        out |= {h + (S, S, True) for h in own}
    if S <= Se:
        out |= {h + (S, Se, False) for h in own}
    return out


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
    """(config, port params, batch, the unsplit port step, the
    reference's jitted step) in float32, once per config."""
    jcfg, tcfg = _cfgs(key)
    jp, tp = _params(key, 1)
    batch = _train_batch(tcfg, S_TRAIN, seed=3)
    return (tcfg, tp, batch, _port_step(tcfg, SHAPE_T, tp, batch),
            _ref_step(jcfg, jp, batch))


def _clip_scale(metrics) -> float:
    """The step's global-norm clip scale (`optim.adamw.update`'s
    max_grad_norm of 1): one scalar that moves every leaf's moments
    alike."""
    return min(1.0, 1.0 / max(metrics["grad_norm"], 1e-6))


def _held_leaves(got, unsplit, ref):
    """Every parameter and moment of ``got`` (placed) within F32_REF of
    ``ref``'s and within F32_TOL of ``unsplit``'s (relative L2), each
    (params, opt state, metrics). The moments are compared with each
    step's clip scale divided out (m by it, v by its square). A
    parameter may also read up to twice ``unsplit``'s own gap to ``ref``
    where that exceeds F32_TOL: a leaf that starts at zero (RWKV-6's
    token-shift mixes) is all AdamW update after one step, whose ratio
    m / sqrt(v) magnifies the moments' rounding."""
    (p2, s2, m2), (p1, s1, m1), (jp3, s3, m3) = got, unsplit, ref
    for kind, power in (("param", 0), ("m", 1), ("v", 2)):
        a_t, b_t, c_t = ((p2, p1, jp3) if kind == "param" else
                         (getattr(s2, kind), getattr(s1, kind),
                          getattr(s3, kind)))
        sa, sb, sc = (_clip_scale(m) ** power for m in (m2, m1, m3))
        for path, a, b, c in zip(_paths(p1), tree_leaves(a_t),
                                 tree_leaves(b_t), jax.tree.leaves(c_t)):
            a, b, c = _np(a) / sa, _np(b) / sb, _np(c) / sc
            bar = (max(F32_TOL, 2 * _rel_l2(b, c)) if kind == "param"
                   else F32_TOL)
            assert _rel_l2(a, b) <= bar, (kind, path, _rel_l2(a, b), bar)
            assert _rel_l2(a, c) <= F32_REF, (kind, path, _rel_l2(a, c))


@pytest.mark.parametrize("key", sorted(CONFIGS))
@pytest.mark.parametrize("preset,shape", TRAIN)
def test_float32_step_matches_unsplit_and_reference(key, preset, shape,
                                                    monkeypatch):
    """grad_accum 2 on 8 rows of ragged labels, 32 decoder positions (and
    Whisper's 16 or 18 frames): loss, grad norm, lr, every parameter and
    moment within the bars of the module docstring. Whisper calls K3 at
    each shard's heads in the encoder, the decoder's self-attention and
    the cross-attention (every head on each block of a cp call), in every
    layer, position and micro-batch; RWKV-6 calls no kernel."""
    tcfg, tp, batch, (p1, s1, m1), (jp3, s3, m3) = _float32_runs(key)
    mesh = _mesh(shape)
    seen = _recorded_k3(monkeypatch)
    p2, s2, m2 = _port_step(tcfg, SHAPE_T, tp, batch, mesh, preset)
    for k in ("loss", "grad_norm", "lr"):
        assert abs(m2[k] - m1[k]) <= F32_TOL * max(abs(m1[k]), 1e-30), k
        np.testing.assert_allclose(m2[k], m3[k], rtol=F32_REF, atol=1e-7)
    _held_leaves((p2, s2, m2), (p1, s1, m1), (jp3, s3, m3))
    lay = spmd.Layout(tcfg, mesh, cp=preset == "cp")
    if tcfg.attn_free:
        assert not seen and not lay.cp
        return
    assert set(seen) == _expected_k3(tcfg, lay, S_TRAIN)
    # the encoder's and the decoder's self-attention, every layer,
    # position and micro-batch (32 queries over 16 or 18 frames run plain)
    assert len(seen) == 2 * (tcfg.enc_layers + tcfg.n_layers) * mesh.size


@functools.lru_cache(maxsize=None)
def _bf16_ref(key):
    jcfg, _ = _cfgs(key, "bfloat16")
    jp, _ = _params(key, 1)
    return _ref_step(jcfg, jp, _float32_runs(key)[2])


@pytest.mark.parametrize("key,preset,shape", [
    ("whisper", "tp", (2, 2)), ("whisper", "cp", (1, 4)),
    ("rwkv-h6", "tp", (1, 4)), ("rwkv-h6", "cp", (2, 2))])
def test_bf16_step_within_the_references_bf16_error(key, preset, shape):
    """bf16 compute: every parameter no further from the reference's bf16
    step than twice that step is from its float32 step, and the loss
    within 5e-3 of it."""
    _, tcfg = _cfgs(key, "bfloat16")
    _c, tp, batch, _u, (j32, _, _) = _float32_runs(key)
    jb, _, mb = _bf16_ref(key)
    p, _, m = _port_step(tcfg, SHAPE_T, tp, batch, _mesh(shape), preset)
    assert abs(m["loss"] - mb["loss"]) < 5e-3
    ref_err = max(_rel_l2(np.array(a, np.float32), b)
                  for a, b in zip(jax.tree.leaves(jb),
                                  jax.tree.leaves(j32)))
    err = max(_rel_l2(a, b) for a, b in zip(tree_leaves(p),
                                            jax.tree.leaves(jb)))
    assert ref_err > 0 and err <= 2 * ref_err, (err, ref_err)


F64_TOL = 1e-6


@pytest.mark.parametrize("key", ["rwkv", "rwkv-h6"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_rwkv_float64_step_is_the_unsplit_step(key, shape):
    """In float64 compute (`layers.wide` keeps the norms, the recurrence
    and the loss head in float64; the collectives sum float64 pieces in
    float64) the tp step on the mesh is the unsplit step up to the
    float32 masters' and moments' own rounding: the loss and grad norm
    within 1e-6 (relative), every parameter and moment (the clip scale
    divided out) within 1e-6 relative L2. RWKV-6's float32 step at random
    weights magnifies a rounding ~1e4-fold (`chip_smoke.py`'s float64
    check on the card), so this is where a split fault cannot hide."""
    _, cfg = _cfgs(key, "float64")
    _c, tp, batch, *_ = _float32_runs(key)
    p1, s1, m1 = _port_step(cfg, SHAPE_T, tp, batch)
    p2, s2, m2 = _port_step(cfg, SHAPE_T, tp, batch, _mesh(shape), "tp")
    for k in ("loss", "grad_norm"):
        assert abs(m2[k] - m1[k]) <= F64_TOL * abs(m1[k]), k
    for kind, power in (("param", 0), ("m", 1), ("v", 2)):
        a_t, b_t = ((p2, p1) if kind == "param"
                    else (getattr(s2, kind), getattr(s1, kind)))
        sa, sb = (_clip_scale(m) ** power for m in (m2, m1))
        for path, a, b in zip(_paths(p1), tree_leaves(a_t),
                              tree_leaves(b_t)):
            gap = _rel_l2(_np(a) / sa, _np(b) / sb)
            assert gap <= F64_TOL, (kind, path, gap)


def test_rwkv_cp_is_tp_bit_for_bit():
    """RWKV-6 has no attention, so the cp preset is tp: the training step
    (parameters, moments, metrics) and the prefill's logits and cache
    equal tp's bit for bit on (2, 2)."""
    tcfg, tp, batch, *_ = _float32_runs("rwkv")
    mesh = _mesh((2, 2))
    a = _port_step(tcfg, SHAPE_T, tp, batch, mesh, "tp")
    b = _port_step(tcfg, SHAPE_T, tp, batch, mesh, "cp")
    assert a[2] == b[2]
    for x, y in zip(tree_leaves(a[:2]), tree_leaves(b[:2])):
        assert torch.equal(_whole(x), _whole(y))
    pb = tsteps.place_batch(mesh, tcfg, ShapeConfig("p", 16, B, "prefill"),
                            _inputs(tcfg, 16, 5))
    P = M.place_tree(tp, tsteps.plan(tcfg, ShapeConfig("p", 16, B,
                                                       "prefill"),
                                     mesh)[2][0])
    la, ca = spmd.prefill(tcfg, mesh, P, pb)
    lb, cb = spmd.prefill(tcfg, mesh, P, pb, cp=True)
    for x, y in zip(tree_leaves((la, ca)), tree_leaves((lb, cb))):
        assert torch.equal(_whole(x), _whole(y))


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
def _unsplit_serving(key, int8):
    """The unsplit float32 run: (params, prompt batch, fed tokens, the
    prefill's last logits, its bf16 cache, the cache the decode steps
    start from (int8 where asked, else its floating leaves in float32:
    module docstring), each decode step's logits, the cache after
    them)."""
    _, tcfg = _cfgs(key)
    _jp, tp = _params(key, 2)
    batch = _inputs(tcfg, PROMPT, seed=5)
    feed = [torch.from_numpy(f) for f in np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (NEW, B, 1)).astype(np.int32)]
    last, cache = decoding.prefill(tcfg, tp, _torch_batch(tcfg, batch),
                                   max_len=PROMPT + NEW)
    bf16 = _clone(cache)
    if int8:
        cache = decoding.quantize_cache(tcfg, cache)
    else:
        cache = tree_map(lambda t: t.float() if t.is_floating_point()
                         else t, cache)
    start = _clone(cache)
    logits = []
    for t, tok in enumerate(feed):
        lg, cache = decoding.decode_step(tcfg, tp, cache, tok, PROMPT + t)
        logits.append(lg)
    return tp, batch, feed, last, bf16, start, logits, cache


def _cache_close(got, want):
    """Each leaf of a placed mesh cache against the unsplit one: bf16
    leaves (k, v, xk, xv, x_tm, x_cm) per element within one bf16
    rounding, int8 values within 1, float32 ones (RWKV's state, the
    float32 slots) within 1e-5 (relative L2), positions equal."""
    assert set(got) == set(want)
    for name, w in want.items():
        g = _whole(got[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "pos":
            assert torch.equal(g, w)
        elif w.dtype == torch.int8:
            assert int((g.int() - w.int()).abs().max()) <= 1
        elif w.dtype == torch.float32:
            assert _rel_l2(g, w) <= F32_TOL, (name, _rel_l2(g, w))
        else:
            assert torch.allclose(g.float(), w.float(), rtol=2 ** -7,
                                  atol=1e-6), name


@pytest.mark.parametrize("key", sorted(CONFIGS))
@pytest.mark.parametrize("preset,shape", SERVE)
def test_float32_prefill_and_decode_match_unsplit(key, preset, shape,
                                                  monkeypatch):
    """8 prompts of 12 tokens (and Whisper's frames): the plan's prefill
    step's logits within 1e-5 of the unsplit prefill's largest, the cache
    of 15 slots (`spmd.prefill`, placed by `meshes.cache_shardings`)
    within one bf16 rounding per element and RWKV's state within 1e-5;
    Whisper's K3 calls at each shard's heads (the encoder's blocks under
    cp). Then 3 decode steps of the plan from the unsplit prefill's cache
    placed on the mesh (int8 under serve8 for Whisper), each step's
    logits within 1e-5 and the cache after them as the unsplit one's."""
    _, tcfg = _cfgs(key)
    int8 = preset == "serve8" and decoding.has_int8_cache(tcfg)
    tp, batch, feed, last, bf16, start, logits, end = _unsplit_serving(
        key, int8)
    mesh = _mesh(shape)
    rules = tsteps.resolve_rules(preset)
    pfn, _s, pins, pouts, _d = tsteps.plan(
        tcfg, ShapeConfig("p", PROMPT, B, "prefill"), mesh, rules)
    P = M.place_tree(tp, pins[0])
    seen = _recorded_k3(monkeypatch)
    lg, _c = pfn(P, batch)
    assert lg.spec == pouts[0].spec
    assert _max_abs(lg, last) <= F32_TOL * float(last.abs().max())
    lay = spmd.Layout(tcfg, mesh, cp=preset == "cp")
    if tcfg.enc_dec:
        assert set(seen) == _expected_k3(tcfg, lay, PROMPT)
    else:
        assert not seen
    pb = tsteps.place_batch(mesh, tcfg, ShapeConfig("p", PROMPT, B,
                                                    "prefill"), batch)
    _, cache = spmd.prefill(tcfg, mesh, P, pb, max_len=PROMPT + NEW,
                            cp=preset == "cp")
    for name, x in cache.items():
        assert x.spec == M.cache_shardings(mesh, {name: x})[name].spec
    _cache_close(cache, bf16)
    dfn, _s, dins, douts, _d = tsteps.plan(
        tcfg, ShapeConfig("d", PROMPT + NEW, B, "decode"), mesh, rules)
    P = M.place_tree(tp, dins[0])
    cache = M.place_tree(_clone(start), dins[1])
    for t, tok in enumerate(feed):
        lg, cache = dfn(P, cache, tok, PROMPT + t)
        assert lg.spec == douts[0].spec
        assert _max_abs(lg, logits[t]) <= F32_TOL * float(
            logits[t].abs().max()), t
    _cache_close(cache, end)


@functools.lru_cache(maxsize=None)
def _ref_serving(key):
    """The reference's jitted prefill and decode steps on the prompts and
    fed tokens of `_unsplit_serving`."""
    jcfg, _ = _cfgs(key)
    jp, _ = _params(key, 2)
    _tp, batch, feed, *_ = _unsplit_serving(key, False)
    last, cache = jax.jit(lambda p, b: jdec.prefill(
        jcfg, p, b, max_len=PROMPT + NEW))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    step = jax.jit(lambda p, c, t, s: jdec.decode_step(jcfg, p, c, t, s))
    out = []
    for t, tok in enumerate(feed):
        lg, cache = step(jp, cache, jnp.asarray(tok.numpy()),
                         jnp.int32(PROMPT + t))
        out.append(np.asarray(lg, np.float32))
    return np.asarray(last, np.float32), out


@pytest.mark.parametrize("key", ["whisper", "rwkv-h6"])
@pytest.mark.parametrize("preset,shape", [("tp", (2, 2)), ("cp", (1, 4))])
def test_mesh_serving_matches_the_reference(key, preset, shape):
    """The mesh prefill's last logits within 1e-4 of the reference's
    jitted prefill, and 3 decode steps from the mesh prefill's own bf16
    cache within CACHE_TOL of the reference's."""
    _, tcfg = _cfgs(key)
    tp, batch, feed, *_ = _unsplit_serving(key, False)
    jlast, jlogits = _ref_serving(key)
    mesh = _mesh(shape)
    fn, _s, ins, _o, _d = tsteps.plan(
        tcfg, ShapeConfig("d", PROMPT + NEW, B, "decode"), mesh,
        tsteps.resolve_rules(preset))
    P = M.place_tree(tp, ins[0])
    pb = tsteps.place_batch(mesh, tcfg, ShapeConfig("p", PROMPT, B,
                                                    "prefill"), batch)
    lg, cache = spmd.prefill(tcfg, mesh, P, pb, max_len=PROMPT + NEW,
                             cp=preset == "cp")
    assert _max_abs(lg, jlast) <= F32_REF * float(np.abs(jlast).max())
    for t, tok in enumerate(feed):
        lg, cache = fn(P, cache, tok, PROMPT + t)
        np.testing.assert_allclose(_whole(lg).numpy(), jlogits[t],
                                   rtol=CACHE_TOL, atol=CACHE_TOL)


# --------------------------------------------------------------------------
# the head bank, the cache's placement, the training loop
# --------------------------------------------------------------------------

def test_rwkv_head_bank_and_channel_keys_cut():
    """`rwkv.time_mix_heads` on one block of heads' weights gives that
    block's columns of the whole bank's y and its heads' state, and
    `time_mix` is the whole bank through ``w_o``, bit for bit;
    `channel_mix_keys` on a block of ``c_wk``'s columns gives those
    columns, and `channel_mix` is the keys through ``c_wv`` under the
    gate, bit for bit."""
    _, cfg = _cfgs("rwkv-h6")
    _jp, tp = _params("rwkv-h6", 3)
    p = transformer.layer_params(tp["blocks"], 0)["rwkv"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32))
    y, st, last = rwkv.time_mix_heads(cfg, p, x)
    out, st2, last2 = rwkv.time_mix(cfg, p, x)
    assert torch.equal(out, y @ p["w_o"]) and torch.equal(st, st2)
    assert torch.equal(last, last2) and torch.equal(last, x[:, -1])
    Dh = cfg.resolved_head_dim
    lo, hi = 2, 4
    cut = dict(p, w0=p["w0"][lo * Dh:hi * Dh],
               ln_g=p["ln_g"][lo * Dh:hi * Dh], u_bonus=p["u_bonus"][lo:hi])
    for k in ("w_r", "w_k", "w_v", "w_g", "w_lora_b"):
        cut[k] = p[k][:, lo * Dh:hi * Dh]
    yc, stc, _ = rwkv.time_mix_heads(cfg, cut, x)
    torch.testing.assert_close(yc, y[..., lo * Dh:hi * Dh], rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(stc, st[:, lo:hi], rtol=1e-6, atol=1e-7)
    k, xr = rwkv.channel_mix_keys(cfg, p, x)
    o, _ = rwkv.channel_mix(cfg, p, x)
    assert torch.equal(o, torch.sigmoid(xr @ p["c_wr"]) * (k @ p["c_wv"]))
    kc, _ = rwkv.channel_mix_keys(cfg, dict(p, c_wk=p["c_wk"][:, 10:40]), x)
    torch.testing.assert_close(kc, k[..., 10:40], rtol=1e-6, atol=1e-7)


class _FakeMesh:
    """What the reference's `cache_shardings` reads of a mesh: its axis
    sizes."""

    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (1, 5), (2, 3)])
def test_cache_placements_are_the_references(shape, monkeypatch):
    """`meshes.cache_shardings` of Whisper's and RWKV-6's decode caches
    (the published configs, 8 rows, 256 slots) equals the reference's
    `cache_shardings` rule by rule: Whisper's xk / xv cut by Se = 1500
    over "model" where it divides (2, 4, 5; not 3), RWKV's state by H =
    40 (2, 4, 5; not 3), the token shifts by rows only. The reference's
    function is called with a stand-in mesh of the same axis sizes (its
    rules read only those), its `NamedSharding` recording the spec."""
    monkeypatch.setattr(jmeshes, "NamedSharding", lambda _m, spec: spec)
    mesh = _mesh(shape)
    for name in ("whisper-large-v3", "rwkv6-3b"):
        tspec = decoding.cache_spec(T_FULL[name], ShapeConfig(
            "d", 256, 8, "decode"))
        jspec = jdec.cache_spec(J_FULL[name], JShape("d", 256, 8,
                                                     "decode"))
        got = M.cache_shardings(mesh, spmd.meta_tree(tspec))
        want = jmeshes.cache_shardings(_FakeMesh(shape), jspec)
        assert set(got) == set(want)
        for leaf in got:
            assert tuple(got[leaf].spec) == tuple(want[leaf]), (name, leaf)
    m = shape[1]
    got = M.cache_shardings(mesh, spmd.meta_tree(decoding.cache_spec(
        T_FULL["whisper-large-v3"], ShapeConfig("d", 256, 8, "decode"))))
    assert got["xk"].spec[2] == ("model" if 1500 % m == 0 else None)
    got = M.cache_shardings(mesh, spmd.meta_tree(decoding.cache_spec(
        T_FULL["rwkv6-3b"], ShapeConfig("d", 256, 8, "decode"))))
    assert got["state"].spec[2] == ("model" if 40 % m == 0 else None)
    assert got["x_tm"].spec == M.P(None, "data", None)


@pytest.mark.parametrize("key", ["whisper", "rwkv"])
def test_train_on_a_mesh_matches_one_device(key):
    """`launch.train` over (2, 2) (Whisper's frames from the token
    pipeline, placed with the rows) against the same run on one device,
    float32, 2 steps, held by the one-device run's own rounding: its gap
    to the same run in float64 compute. The losses within 1e-5; every
    moment within 1e-5 (relative L2) or twice the largest of its kind's
    own gaps: after two steps a moment carries the first step's clip
    scale and parameter rounding as well as the second's, which no one
    scale divides out (each step alone holds every moment at 1e-5,
    `_held_leaves`); every parameter per element within 1e-5
    of its leaf's largest value plus 1e-4 of the leaf's largest change
    over the run (`tests/test_torch_lm_mesh_families.py`'s bar) plus
    twice the leaf's largest own gap (a leaf that starts at zero is all
    AdamW update, whose ratio m / sqrt(v) magnifies the moments'
    rounding)."""
    _, cfg = _cfgs(key)
    shape = ShapeConfig("t", 16, B, "train", grad_accum=2)
    one = ttrain.train(cfg, shape, 2, None, mesh=_mesh((1, 1)),
                       log_every=0, device="cpu")
    exact = ttrain.train(dataclasses.replace(cfg, dtype="float64"), shape,
                         2, None, mesh=_mesh((1, 1)), log_every=0,
                         device="cpu")
    got = ttrain.train(cfg, shape, 2, None, mesh=_mesh((2, 2)), log_every=0)
    assert got["mesh"] == (("data", 2), ("model", 2))
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=F32_TOL)
    start, _ = ttrain.build_state(cfg, "cpu")
    for path, a, b, c, b0 in zip(
            _paths(start), tree_leaves(got["params"]),
            tree_leaves(one["params"]), tree_leaves(exact["params"]),
            tree_leaves(start)):
        moved = float((b - b0).abs().max())
        bar = (F32_TOL * float(b.abs().max()) + F32_REF * moved
               + 2 * _max_abs(b, c))
        assert _max_abs(a, b) <= bar, path
    for kind in ("m", "v"):
        trip = [(a, b, c) for a, b, c in zip(
            tree_leaves(getattr(got["opt"], kind)),
            tree_leaves(getattr(one["opt"], kind)),
            tree_leaves(getattr(exact["opt"], kind)))]
        bar = max(F32_TOL, 2 * max(_rel_l2(b, c) for _a, b, c in trip))
        for a, b, _c in trip:
            assert _rel_l2(a, b) <= bar, kind
