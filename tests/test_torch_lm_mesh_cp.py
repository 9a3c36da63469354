"""The context-parallel preset ("cp") over a (data, model) mesh, and K3
with fewer queries than keys, on the CPU.

Under cp (`distributed.spmd`) model shard r projects its block of S/m
positions with every head and K3 takes the block's queries over the keys
up to the block's end, the causal mask aligned bottom-right
(`kernels.ref.flash_attention_ref`, the kernel's plain version, here).
The preset changes placements only: its steps equal the tp preset's and
the unsplit ones, and the JAX package's unsharded step under plain
``jax.jit``. Where S does not divide by the model axis, and in a decode
step, attention runs as under tp.

Bars, those of `tests/test_torch_lm_mesh_steps.py`: float32, within 1e-5
(relative L2) of the unsplit step and of the tp preset's, within 1e-4 of
the reference's.
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
from repro.models import attention as jattn
from repro.models import decoding as jdec
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro_torch.configs import REDUCED_ARCHS as T_ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import meshes as M
from repro_torch.distributed import spmd
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import decoding
from repro_torch.models.layers import params_from_numpy, tree_leaves
from repro_torch.models.layers import tree_map
from repro_torch.optim import adamw

CPU = torch.device("cpu")
F32_TOL = 1e-5
F32_REF = 1e-4
B = 8
# reduced Granite has 4 heads; the second config's 16 heads and 4 KV
# heads ("kv_flat": split over "model" by CP_RULES only)
CONFIGS = {"granite": ("granite-3-2b", {}),
           "granite-h16": ("granite-3-2b", dict(n_heads=16, n_kv_heads=4,
                                                head_dim=4)),
           # a sliding window of 16 over 32 tokens: a shard's call keeps
           # the plain route, at its offset
           "mixtral": ("mixtral-8x7b", {})}


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     [CPU] * int(np.prod(shape)))


def _cfgs(key, dtype="float32"):
    name, over = CONFIGS[key]
    over = dict(over, dtype=dtype)
    return (dataclasses.replace(J_ARCHS[name], **over),
            dataclasses.replace(T_ARCHS[name], **over))


def _batch(cfg, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)],
                            1)
    for r in range(B):
        labels[r, :(0, 5, 2, 9)[r % 4]] = -1
    return {"tokens": toks, "labels": labels}


def _whole(x):
    return x.gather(CPU) if M.is_placed(x) else x


def _rel_l2(a, b) -> float:
    a = _whole(a).float().numpy()
    b = _whole(b).float().numpy() if isinstance(b, torch.Tensor) \
        or M.is_placed(b) else np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _recorded_kernel_calls(monkeypatch):
    """Record (Sq, Sk, causal) of every `ops.flash_attention` call."""
    seen = []
    real = ops.flash_attention

    def counted(q, k, v, *, causal=True):
        seen.append((q.shape[2], k.shape[2], causal))
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(ops, "flash_attention", counted)
    return seen


def _port_step(cfg, shape, params, batch, mesh=None, preset=None):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = tree_map(torch.clone, params)
    if mesh is None:
        fn = tsteps.make_train_step(cfg, shape)
        p, st, m = fn(params, adamw.init(params), tb)
        return p, st, {k: float(v) for k, v in m.items()}
    fn, _s, ins, outs, _d = tsteps.plan(cfg, shape, mesh,
                                        tsteps.resolve_rules(preset))
    P = M.place_tree(params, ins[0])
    P, O, m = fn(P, tsteps.init_opt(P), tb)
    for x, pl in zip(tree_leaves(P), tree_leaves(outs[0])):
        assert x.spec == pl.spec
    return P, O, {k: float(v) for k, v in m.items()}


@functools.lru_cache(maxsize=None)
def _float32_runs(key, S):
    """(config, params, batch, the unsplit port step, the reference's
    step), grad_accum 2, once per config and length."""
    jcfg, tcfg = _cfgs(key)
    jp = jtr.build_param_table(jcfg).init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(tcfg, S, seed=3)
    unsplit = _port_step(tcfg, ShapeConfig("t", S, B, "train",
                                           grad_accum=2), tp, batch)
    fn = jax.jit(jsteps.make_train_step(jcfg, JShape("t", S, B, "train",
                                                     grad_accum=2)))
    jp2, st, m = fn(jp, jadamw.init(jp),
                    {k: jnp.asarray(v) for k, v in batch.items()})
    return tcfg, tp, batch, unsplit, (jp2, st, {k: float(v)
                                                for k, v in m.items()})


@pytest.mark.parametrize("key,S,shape", [
    ("granite", 16, (2, 2)), ("granite", 16, (1, 4)),
    ("granite-h16", 16, (2, 4)), ("granite", 15, (2, 2)),
    ("mixtral", 32, (2, 2))])
def test_cp_train_step_matches_tp_unsplit_and_reference(key, S, shape,
                                                        monkeypatch):
    """grad_accum 2 on 8 rows of ragged labels: the cp step's loss, grad
    norm and every parameter and moment within 1e-5 of the tp step's and
    the unsplit step's, within 1e-4 of the reference's. Where m divides
    S, each model shard's K3 calls take its S/m queries over the keys up
    to its block's end (Mixtral's second block, whose keys reach past its
    window of 16, the plain route at its offset); at S = 15 every call is
    the whole sequence's, as under tp."""
    tcfg, tp, batch, (p1, s1, m1), (jp3, s3, m3) = _float32_runs(key, S)
    shape_t = ShapeConfig("t", S, B, "train", grad_accum=2)
    seen = _recorded_kernel_calls(monkeypatch)
    pc, sc, mc = _port_step(tcfg, shape_t, tp, batch, _mesh(shape), "cp")
    m, win = shape[1], tcfg.swa_window
    if S % m == 0:
        # a block whose keys reach past the window keeps the plain route
        blk = S // m
        want = {(blk, (r + 1) * blk, True) for r in range(m)
                if not win or win >= (r + 1) * blk}
        assert want and set(seen) == want
    else:
        assert set(seen) == {(S, S, True)}
    pt, st, mt = _port_step(tcfg, shape_t, tp, batch, _mesh(shape), "tp")
    for k in ("loss", "grad_norm", "lr", "moe_aux"):
        for other in (m1, mt):
            assert abs(mc[k] - other[k]) <= F32_TOL * max(abs(other[k]),
                                                          1e-30), k
        np.testing.assert_allclose(mc[k], m3[k], rtol=F32_REF, atol=1e-7)
    for a, b, c, d in zip(tree_leaves((pc, sc.m, sc.v)),
                          tree_leaves((pt, st.m, st.v)),
                          tree_leaves((p1, s1.m, s1.v)),
                          jax.tree.leaves((jp3, s3.m, s3.v))):
        assert _rel_l2(a, b) <= F32_TOL
        assert _rel_l2(a, c) <= F32_TOL
        assert _rel_l2(a, d) <= F32_REF


@pytest.mark.parametrize("key,S,shape", [
    ("granite", 16, (2, 2)), ("granite-h16", 16, (1, 4)),
    ("granite", 15, (2, 2))])
def test_cp_prefill_and_decode_match_tp_unsplit_and_reference(key, S,
                                                              shape):
    """A cp prefill (plan's prefill step) of 8 prompts: last logits within
    1e-5 of the tp preset's and the unsplit prefill's and within 1e-4 of
    the reference's jitted prefill, its bf16 cache equal to the tp
    prefill's within a bf16 rounding; two decode steps from it under the
    cp plan (a decode step never runs context-parallel) equal the tp
    plan's from the tp prefill's cache."""
    jcfg, tcfg = _cfgs(key)
    jp = jtr.build_param_table(jcfg).init(jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tok_np = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    tok = torch.from_numpy(tok_np)
    mesh = _mesh(shape)
    want, _ = decoding.prefill(tcfg, tp, {"tokens": tok}, max_len=S + 2)
    jlg, _ = jax.jit(lambda p, b: jdec.prefill(jcfg, p, b))(
        jp, {"tokens": jnp.asarray(tok_np)})
    got = {}
    for preset in ("cp", "tp"):
        fn, _s, ins, _o, _d = tsteps.plan(
            tcfg, ShapeConfig("d", S + 2, B, "decode"), mesh,
            tsteps.resolve_rules(preset))
        P = M.place_tree(tp, ins[0])
        lg, cache = spmd.prefill(tcfg, mesh, P, M.place(
            tok, M.data_sharding(mesh, B, 2)), max_len=S + 2,
            cp=preset == "cp")
        out = [lg.gather(CPU)]
        keys = cache["k"].gather(CPU).float()
        for t in range(2):
            nxt = out[-1].argmax(-1, keepdim=True).int() if t == 0 else \
                out[-1][:, 0].argmax(-1, keepdim=True).int()
            lg, cache = fn(P, cache, nxt, S + t)
            out.append(lg.gather(CPU))
        got[preset] = (out, keys)
    (cp_out, cp_keys), (tp_out, tp_keys) = got["cp"], got["tp"]
    scale = float(want.abs().max())
    assert float((cp_out[0] - want).abs().max()) <= F32_TOL * scale
    assert float((cp_out[0] - tp_out[0]).abs().max()) <= F32_TOL * scale
    ref_lg = np.asarray(jlg, np.float32)
    assert float(np.abs(cp_out[0].numpy() - ref_lg).max()) <= \
        F32_REF * float(np.abs(ref_lg).max())
    assert torch.allclose(cp_keys, tp_keys, rtol=2 ** -7, atol=1e-6)
    for a, b in zip(cp_out[1:], tp_out[1:]):
        assert float((a - b).abs().max()) <= F32_TOL * scale


def test_cp_prefill_through_the_plan_runs_each_shards_block(monkeypatch):
    """`launch.steps.plan`'s cp prefill runs context-parallel: over (1, 4)
    at S = 16 each shard's K3 call is its 4 queries over 4, 8, 12 and 16
    keys; the tp plan's calls are the whole sequence's."""
    _, tcfg = _cfgs("granite")
    params = tsteps.transformer.build_param_table(tcfg).init(
        torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    mesh = _mesh((1, 4))
    tok = torch.zeros((2, 16), dtype=torch.int32)
    seen = _recorded_kernel_calls(monkeypatch)
    for preset, want in (("cp", [(4, 4), (4, 8), (4, 12), (4, 16)]),
                         ("tp", [(16, 16)] * 4)):
        seen.clear()
        fn, _s, ins, _o, _d = tsteps.plan(
            tcfg, ShapeConfig("p", 16, 2, "prefill"), mesh,
            tsteps.resolve_rules(preset))
        fn(M.place_tree(params, ins[0]), {"tokens": tok})
        assert [s[:2] for s in seen[:4]] == want
        assert len(seen) == 4 * tcfg.n_layers


# --------------------------------------------------------------------------
# K3 with fewer queries than keys
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
@pytest.mark.parametrize("Sq,Sk", [(5, 19), (16, 16), (1, 7), (12, 40)])
def test_plain_k3_at_fewer_queries_matches_reference_full_attention(
        Sq, Sk, H, KV, causal):
    """`kernels.ref.flash_attention_ref` at q (B,H,Sq,D), k/v (B,KV,Sk,D):
    the reference's `full_attention` with q_offset = Sk - Sq (its causal
    mask then bottom-right), float32, G = 1 and G = 4, causal and full."""
    rng = np.random.default_rng(Sq * 100 + Sk)
    D = 16
    q = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((2, Sk, KV, D)).astype(np.float32)
    v = rng.standard_normal((2, Sk, KV, D)).astype(np.float32)
    want = jattn.full_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                q_offset=Sk - Sq)
    got = ref.flash_attention_ref(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
        causal=causal).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("Sq,Sk,window,q_offset,causal,expect", [
    (4, 16, 0, 12, True, True), (4, 16, 0, 0, True, False),
    (4, 16, 0, 0, False, True), (4, 16, 0, 7, False, True),
    (16, 4, 0, 0, False, False), (4, 16, 16, 12, True, True),
    (4, 16, 15, 12, True, False), (4, 16, 8, 0, False, True),
    (4, 16, 3, 0, False, False)])
def test_kernel_route_for_fewer_queries(Sq, Sk, window, q_offset, causal,
                                        expect):
    """Sq <= Sk goes to the kernel when its mask is the kernel's: causal at
    q_offset = Sk - Sq (bottom-right), or full at any offset; never with
    more queries than keys, nor with a window that cuts keys."""
    assert tattn.uses_kernel(Sq, Sk, window=window, q_offset=q_offset,
                             is_global=None, causal=causal) is expect


def test_attention_at_an_offset_with_a_window_stays_plain_and_right():
    """A block of queries at an offset over more keys than the chunk, with
    a window that cuts keys: the plain route at that offset (not the
    blocked one, which takes none) equals the rows of the whole
    sequence's attention."""
    rng = np.random.default_rng(0)
    S, blk = 32, 8
    q, k, v = (torch.from_numpy(rng.standard_normal((2, S, n, 16))
                                .astype(np.float32)) for n in (4, 2, 2))
    whole = tattn.attention(q, k, v, window=6, chunk=8)
    for lo in range(0, S, blk):
        part = tattn.attention(q[:, lo:lo + blk], k[:, :lo + blk],
                               v[:, :lo + blk], window=6, chunk=8,
                               q_offset=lo)
        torch.testing.assert_close(part, whole[:, lo:lo + blk], rtol=1e-5,
                                   atol=1e-6)


def test_cp_refuses_only_the_families_the_mesh_does_not_run():
    """The cp preset refuses no family (the mesh layer runs them all), and
    it acts only where there is attention: on (2, 2) and (1, 4), every
    reduced config passes `spmd.check_supported`, its `spmd.Layout` is
    context-parallel exactly when the family has attention (RWKV-6's cp
    is tp), and `plan`'s cp training step takes and returns the
    parameters, moments and batch placed as the tp step's (cp changes
    only the activations inside the step)."""
    shape = ShapeConfig("t", 16, 8, "train", grad_accum=2)
    for mshape in ((2, 2), (1, 4)):
        mesh = _mesh(mshape)
        for cfg in T_ARCHS.values():
            spmd.check_supported(cfg, mesh)
            assert spmd.Layout(cfg, mesh, cp=True).cp == (not cfg.attn_free)
            _f, _s, ins, outs, _d = tsteps.plan(
                cfg, shape, mesh, tsteps.resolve_rules("cp"))
            _f, _s, tins, touts, _d = tsteps.plan(
                cfg, shape, mesh, tsteps.resolve_rules("tp"))
            assert ([x.spec for x in tree_leaves((ins, outs))]
                    == [x.spec for x in tree_leaves((tins, touts))]), cfg.name
