"""The LM serving slice of the port (`repro_torch.models`, `launch.steps`)
against the JAX package (`repro.models`) at reduced sizes on the CPU.

Weights come from the reference's `ParamTable.init` and are carried over
with `params_from_numpy`; inputs are made with numpy from a seed. The
kernels run as their plain versions here (CPU tensors).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED_ARCHS as J_ARCHS
from repro.models import attention as jattn
from repro.models import decoding as jdec
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro_torch.configs import ARCHS as T_FULL
from repro_torch.configs import REDUCED_ARCHS as T_ARCHS
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import attention as tattn
from repro_torch.models import decoding as tdec
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import (ParamTable, params_from_numpy,
                                       tree_map)
from test_torch_families import family_batch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SUPPORTED = ["granite-20b", "granite-3-2b", "hymba-1.5b", "mixtral-8x7b",
             "moonshot-v1-16b-a3b", "qwen1.5-110b", "qwen2-vl-7b",
             "qwen2.5-32b", "rwkv6-3b", "whisper-large-v3"]
# the serving parity tests: a dense, the hybrid, both MoE families, the
# VLM, RWKV-6 and Whisper's encoder-decoder
SERVED = ["hymba-1.5b", "granite-3-2b", "mixtral-8x7b",
          "moonshot-v1-16b-a3b", "qwen2-vl-7b", "rwkv6-3b",
          "whisper-large-v3"]
# float32 compute: the two packages run the same float32 algorithm in
# another summation order
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# float32 compute over the bf16 KV cache of both packages: a k or v whose
# float32 values differ in the last bits may round to neighbouring bf16
# values (2^-8 relative), which moves logits of size ~4 by ~1e-3
CACHE_TOL = dict(rtol=2e-2, atol=2e-2)
# bf16 compute: tests/test_models.py's bar for decode against forward
BF16_TOL = dict(rtol=0.1, atol=0.15)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(name, dtype="float32", seed=1):
    jcfg = dataclasses.replace(J_ARCHS[name], dtype=dtype)
    tcfg = dataclasses.replace(T_ARCHS[name], dtype=dtype)
    jp = jtr.build_param_table(jcfg).init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _batches(cfg, toks, S, seed):
    """The reference's and the port's batch of the first S tokens, with
    the family's stub-frontend inputs (`test_torch_families.family_batch`:
    vision embeddings and M-RoPE positions, encoder frames)."""
    extra = family_batch(cfg, toks.shape[0], toks.shape[1], seed)
    batch = {"tokens": toks[:, :S]}
    for k, v in extra.items():
        if k != "tokens":
            batch[k] = v[:, :S] if k == "positions" else v
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


def _leaves(tree):
    """Leaves in jax.tree order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# --------------------------------------------------------------------------
# configs and parameters
# --------------------------------------------------------------------------

def test_configs_are_the_reference_configs():
    from repro.configs import ARCHS as J_FULL
    assert sorted(T_FULL) == sorted(J_FULL)
    for name in J_FULL:
        assert dataclasses.asdict(T_FULL[name]) == \
            dataclasses.asdict(J_FULL[name])
        assert dataclasses.asdict(T_ARCHS[name]) == \
            dataclasses.asdict(J_ARCHS[name])
    hymba = T_FULL["hymba-1.5b"]
    assert (hymba.n_layers, hymba.d_model, hymba.n_heads, hymba.n_kv_heads,
            hymba.resolved_head_dim, hymba.d_ff, hymba.vocab_size,
            hymba.ssm_state, hymba.swa_window, hymba.global_attn_every) == \
        (32, 1600, 25, 5, 64, 5504, 32001, 16, 1024, 8)


@pytest.mark.parametrize("name", SUPPORTED)
def test_param_table_matches_reference(name):
    """Same paths and shapes; init rules: ones/zeros exact, normal leaves
    at the reference's scale (std within 10% on these sizes)."""
    jt = jtr.build_param_table(J_ARCHS[name])
    tt = ttr.build_param_table(T_ARCHS[name])
    jshapes = {k: v[0] for k, v in jt.defs.items()}
    assert {k: v[0] for k, v in tt.defs.items()} == jshapes
    params = tt.init(torch.Generator().manual_seed(0), device="cpu",
                     dtype=torch.bfloat16)
    for path, (shape, kind, scale) in tt.defs.items():
        leaf = params
        for part in path.split("/"):
            leaf = leaf[part]
        assert tuple(leaf.shape) == shape and leaf.dtype == torch.bfloat16
        assert kind == jt.defs[path][3] and scale == jt.defs[path][4]
        if kind == "ones":
            assert bool((leaf == 1).all())
        elif kind == "zeros":
            assert bool((leaf == 0).all())
        elif leaf.numel() >= 1000:
            std = float(leaf.float().std())
            assert abs(std / scale - 1) < 0.1, (path, std, scale)


def test_params_from_numpy_keeps_or_casts_types():
    bf = np.asarray(jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16))
    tree = {"a": {"w": np.ones((2, 3), np.float32)}, "b": [bf],
            "i": np.arange(3, dtype=np.int32)}
    kept = params_from_numpy(tree, "cpu")
    assert kept["a"]["w"].dtype == torch.float32
    assert kept["b"][0].dtype == torch.bfloat16
    assert kept["b"][0].tolist() == [1.5, -2.25, 3.0]
    cast = params_from_numpy(tree, "cpu", dtype=torch.bfloat16)
    assert cast["a"]["w"].dtype == torch.bfloat16
    assert cast["i"].dtype == torch.int32


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _attn_inputs(B, Sq, Sk, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32))


ATTN_CASES = [  # (causal, window, is_global)
    (True, 0, None), (False, 0, None), (True, 8, None), (True, 8, True),
    (True, 8, False), (True, 40, None)]


@pytest.mark.parametrize("causal,window,is_global", ATTN_CASES)
def test_full_chunked_blocked_attention_match_reference(causal, window,
                                                        is_global):
    """float32: 1e-4 (another summation order, online softmax)."""
    q, k, v = _attn_inputs(2, 32, 32, 4, 2, 16, seed=window + causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jg = None if is_global is None else jnp.asarray(is_global)
    kw = dict(causal=causal, window=window)
    pairs = [
        (jattn.full_attention(jq, jk, jv, is_global=jg, **kw),
         tattn.full_attention(tq, tk, tv, is_global=is_global, **kw)),
        (jattn.full_attention(jq[:, 24:], jk, jv, q_offset=24, is_global=jg,
                              **kw),
         tattn.full_attention(tq[:, 24:], tk, tv, q_offset=24,
                              is_global=is_global, **kw)),
        (jattn.chunked_attention(jq, jk, jv, chunk=8, is_global=jg, **kw),
         tattn.chunked_attention(tq, tk, tv, chunk=8, is_global=is_global,
                                 **kw)),
        (jattn.blocked_attention(jq, jk, jv, chunk=4, is_global=jg, **kw),
         tattn.blocked_attention(tq, tk, tv, chunk=4, is_global=is_global,
                                 **kw)),
        (jattn.attention(jq, jk, jv, chunk=8, is_global=jg, **kw),
         tattn.attention(tq, tk, tv, chunk=8, is_global=is_global, **kw)),
    ]
    for want, got in pairs:
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)


@pytest.mark.parametrize("Sq,Sk,window,q_offset,is_global,expect", [
    (16, 16, 0, 0, None, True), (16, 16, 8, 0, None, False),
    (16, 16, 8, 0, True, True), (16, 16, 8, 0, False, False),
    (16, 16, 16, 0, None, True), (16, 16, 40, 0, False, True),
    (16, 16, 16, 4, None, False), (1, 16, 0, 0, None, False)])
def test_kernel_route_is_taken_exactly_when_no_window_cuts(
        Sq, Sk, window, q_offset, is_global, expect):
    assert tattn.uses_kernel(Sq, Sk, window=window, q_offset=q_offset,
                             is_global=is_global) is expect


def test_window_wider_than_keys_gives_the_same_result_both_routes(
        monkeypatch):
    """window >= Sk: the kernel route equals the windowed plain route
    (and the reference's), within float32 summation order."""
    q, k, v = map(torch.from_numpy, _attn_inputs(2, 24, 24, 4, 2, 16, 3))
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return ops.ref.flash_attention_ref(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    via_kernel = tattn.attention(q, k, v, window=24, chunk=8)
    assert calls == [1]
    windowed = tattn.full_attention(q, k, v, window=24)
    blocked = tattn.blocked_attention(q, k, v, window=24, chunk=8)
    want = jattn.attention(*map(jnp.asarray, (q.numpy(), k.numpy(),
                                              v.numpy())),
                           window=24, chunk=8)
    for other in (windowed, blocked):
        torch.testing.assert_close(via_kernel, other, **F32_TOL)
    np.testing.assert_allclose(via_kernel.numpy(), _np(want), **F32_TOL)


@pytest.mark.parametrize("window,is_global", [(0, None), (6, None),
                                              (6, True), (6, False)])
def test_decode_attention_over_a_wrapped_ring_buffer(window, is_global):
    """Write 13 tokens into a W=8 ring through both packages'
    `cache_update`, then attend: float32 within 1e-5 (the cache is
    float32 here: no bf16 rounding)."""
    rng = np.random.default_rng(window)
    B, W, H, KV, D = 2, 8, 4, 2, 16
    jk = jnp.zeros((B, W, KV, D), jnp.float32)
    jv = jnp.zeros((B, W, KV, D), jnp.float32)
    jpos = jnp.full((B, W), -1, jnp.int32)
    tk, tv = torch.zeros(B, W, KV, D), torch.zeros(B, W, KV, D)
    tpos = torch.full((B, W), -1, dtype=torch.int32)
    jg = None if is_global is None else jnp.asarray(is_global)
    for step in range(13):
        kn = rng.standard_normal((B, 1, KV, D)).astype(np.float32)
        vn = rng.standard_normal((B, 1, KV, D)).astype(np.float32)
        q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
        jk, jv, jpos = jattn.cache_update(jk, jv, jpos, jnp.asarray(kn),
                                          jnp.asarray(vn), jnp.int32(step))
        tk2, tv2, tpos2 = tattn.cache_update(tk, tv, tpos, _t(kn), _t(vn),
                                             step)
        assert tk2 is tk and tpos2 is tpos        # written in place
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        want = jattn.decode_attention(jnp.asarray(q), jk, jv, jpos,
                                      window=window, is_global=jg)
        got = tattn.decode_attention(_t(q), tk, tv, tpos, window=window,
                                     is_global=is_global)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


# --------------------------------------------------------------------------
# the SSM heads
# --------------------------------------------------------------------------

def _ssm_pair(seed=2):
    jcfg, tcfg, jp, tp = _pair("hymba-1.5b", seed=seed)
    j_lp = jax.tree.map(lambda a: a[0], jp["blocks"]["ssm"])
    t_lp = {k: v[0] for k, v in tp["blocks"]["ssm"].items()}
    # non-trivial decay and skip (the init makes a_log 0 and d_skip 1)
    rng = np.random.default_rng(seed)
    for name in ("a_log", "d_skip"):
        val = rng.standard_normal(jcfg.n_heads).astype(np.float32) * 0.5
        j_lp[name] = jnp.asarray(val)
        t_lp[name] = _t(val)
    return jcfg, tcfg, j_lp, t_lp


@pytest.mark.parametrize("carried", [False, True])
def test_ssm_scan_matches_reference(carried):
    """float32 prefill scan (through ops.ssm_scan) against the reference's
    lax.scan, with and without a carried state: 1e-4 (the C_t contraction
    is a matmul here, an einsum there)."""
    jcfg, tcfg, j_lp, t_lp = _ssm_pair()
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 12, jcfg.d_model)) * 0.5).astype(np.float32)
    st = None
    if carried:
        st = rng.standard_normal((2, jcfg.n_heads, jcfg.resolved_head_dim,
                                  jcfg.ssm_state)).astype(np.float32)
    jy, jst = jssm.ssm_scan(jcfg, j_lp, jnp.asarray(x),
                            None if st is None else jnp.asarray(st))
    ty, tst = tssm.ssm_scan(tcfg, t_lp, _t(x),
                            None if st is None else _t(st))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **F32_TOL)
    np.testing.assert_allclose(tst.numpy(), _np(jst), **F32_TOL)
    assert tst.dtype == torch.float32


def test_ssm_decode_steps_continue_the_scan():
    """Prefill 8 steps, then 4 single decode steps from the carried state,
    in both packages: float32 within 1e-4; and the port's decode steps
    equal its own 12-step scan."""
    jcfg, tcfg, j_lp, t_lp = _ssm_pair(seed=3)
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2, 12, jcfg.d_model)) * 0.5).astype(np.float32)
    _jy, jst = jssm.ssm_scan(jcfg, j_lp, jnp.asarray(x[:, :8]))
    _ty, tst = tssm.ssm_scan(tcfg, t_lp, _t(x[:, :8]))
    full_y, full_st = tssm.ssm_scan(tcfg, t_lp, _t(x))
    for t in range(8, 12):
        jy, jst = jssm.ssm_decode_step(jcfg, j_lp, jnp.asarray(x[:, t:t + 1]),
                                       jst)
        ty, tst = tssm.ssm_decode_step(tcfg, t_lp, _t(x[:, t:t + 1]), tst)
        np.testing.assert_allclose(ty.numpy(), _np(jy), **F32_TOL)
        np.testing.assert_allclose(tst.numpy(), _np(jst), **F32_TOL)
        torch.testing.assert_close(ty[:, 0], full_y[:, t], **F32_TOL)
    torch.testing.assert_close(tst, full_st, **F32_TOL)


# --------------------------------------------------------------------------
# the whole slice: forward, prefill, decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", SUPPORTED)
def test_forward_matches_reference(name):
    jcfg, tcfg, jp, tp = _pair(name)
    toks = _tokens(jcfg, 2, 24, seed=0)
    jb, tb = _batches(jcfg, toks, 24, seed=0)
    want, want_aux, _ = jtr.forward(jcfg, jp, jb)
    got, aux, (kvs, _) = ttr.forward(tcfg, tp, tb)
    assert kvs is None and aux.dtype == torch.float32
    # the summed load-balancing loss: zero without experts
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0,
                               atol=1e-6)
    assert (float(aux) > 0) == tcfg.is_moe
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)


@pytest.mark.parametrize("name", SERVED)
def test_prefill_and_decode_match_reference(name):
    """float32 compute (bf16 KV cache in both): prefill logits within
    1e-4, every cache leaf within one bf16 rounding, several decode steps
    within CACHE_TOL, through the port's step builders. The prompt (16)
    outgrows the reduced SWA window (16) during decode, so the ring wraps;
    max_len 24 pads the global layers' caches."""
    jcfg, tcfg, jp, tp = _pair(name)
    toks = _tokens(jcfg, 2, 24, seed=4)
    jb, tb = _batches(jcfg, toks, 16, seed=4)
    jlast, jcache = jdec.prefill(jcfg, jp, jb, max_len=24)
    prefill = steps.make_prefill_step(tcfg, max_len=24)
    decode = steps.make_decode_step(tcfg)
    tlast, tcache = prefill(tp, tb)
    np.testing.assert_allclose(tlast.numpy(), _np(jlast), **F32_TOL)
    jl, tl = jax.tree.leaves(jcache), _leaves(tcache)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
        np.testing.assert_allclose(b.float().numpy(), _np(a), rtol=2 ** -7,
                                   atol=1e-6)
    for pos in range(16, 24):
        tok = toks[:, pos:pos + 1]
        jlog, jcache = jdec.decode_step(jcfg, jp, jcache, jnp.asarray(tok),
                                        jnp.int32(pos))
        tlog, tcache = decode(tp, tcache, _t(tok), pos)
        np.testing.assert_allclose(tlog.numpy(), _np(jlog), **CACHE_TOL)


@pytest.mark.parametrize("name", SERVED)
def test_greedy_decode_picks_the_reference_tokens(name):
    """Prefill then greedy decoding for 6 steps, float32 compute: the same
    token ids as the reference at every step."""
    jcfg, tcfg, jp, tp = _pair(name, seed=5)
    toks = _tokens(jcfg, 2, 10, seed=6)
    jb, tb = _batches(jcfg, toks, 10, seed=6)
    jlast, jcache = jdec.prefill(jcfg, jp, jb, max_len=16)
    tlast, tcache = tdec.prefill(tcfg, tp, tb, max_len=16)
    jtok = np.asarray(jnp.argmax(jlast, -1))[:, None].astype(np.int32)
    ttok = tlast.argmax(-1, keepdim=True)
    for pos in range(10, 16):
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        jlog, jcache = jdec.decode_step(jcfg, jp, jcache, jnp.asarray(jtok),
                                        jnp.int32(pos))
        tlog, tcache = tdec.decode_step(tcfg, tp, tcache, ttok, pos)
        jtok = np.asarray(jnp.argmax(jlog[:, 0], -1))[:, None].astype(
            np.int32)
        ttok = tlog[:, 0].argmax(-1, keepdim=True)
    np.testing.assert_array_equal(ttok.numpy(), jtok)


@pytest.mark.parametrize("name", ["hymba-1.5b", "granite-3-2b",
                                  "qwen2-vl-7b", "rwkv6-3b",
                                  "whisper-large-v3"])
def test_bf16_prefill_and_decode_match_reference(name):
    """bf16 compute in both packages, which round at other places:
    test_models.py's bar (rtol 0.1, atol 0.15)."""
    jcfg, tcfg, jp, tp = _pair(name, dtype="bfloat16", seed=7)
    toks = _tokens(jcfg, 2, 20, seed=8)
    jb, tb = _batches(jcfg, toks, 12, seed=8)
    jlast, jcache = jdec.prefill(jcfg, jp, jb, max_len=20)
    tlast, tcache = tdec.prefill(tcfg, tp, tb, max_len=20)
    assert tlast.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tlast.float()), _np(jlast), **BF16_TOL)
    for pos in range(12, 20):
        tok = toks[:, pos:pos + 1]
        jlog, jcache = jdec.decode_step(jcfg, jp, jcache, jnp.asarray(tok),
                                        jnp.int32(pos))
        tlog, tcache = tdec.decode_step(tcfg, tp, tcache, _t(tok), pos)
        np.testing.assert_allclose(_np(tlog.float()), _np(jlog),
                                   **BF16_TOL)


def test_init_cache_matches_reference_layout():
    from repro.configs.base import ShapeConfig as JShape
    from repro_torch.configs.base import ShapeConfig as TShape
    for name in ("hymba-1.5b", "granite-3-2b", "qwen2-vl-7b", "rwkv6-3b",
                 "whisper-large-v3"):
        jc = jdec.init_cache(J_ARCHS[name], JShape("d", 24, 2, "decode"))
        tc = tdec.init_cache(T_ARCHS[name], TShape("d", 24, 2, "decode"),
                             "cpu")
        for a, b in zip(jax.tree.leaves(jc), _leaves(tc)):
            assert tuple(b.shape) == a.shape
            np.testing.assert_array_equal(b.float().numpy(), _np(a))


@pytest.mark.parametrize("S,expect", [(16, 2), (20, 1)])
def test_prefill_sends_unwindowed_attention_and_every_scan_to_the_kernels(
        monkeypatch, S, expect):
    """Reduced Hymba (window 16, global every 2nd of 2 layers): at S <=
    window every layer's attention goes through ops.flash_attention; at
    S > window only the global layer does. Every layer's SSM goes through
    ops.ssm_scan once."""
    _jcfg, tcfg, _jp, tp = _pair("hymba-1.5b")
    seen = {"fa": 0, "scan": 0}
    real_fa, real_scan = ops.flash_attention, ops.ssm_scan

    def fa(*a, **kw):
        seen["fa"] += 1
        return real_fa(*a, **kw)

    def scan(*a, **kw):
        seen["scan"] += 1
        return real_scan(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", fa)
    monkeypatch.setattr(ops, "ssm_scan", scan)
    tdec.prefill(tcfg, tp, {"tokens": _t(_tokens(tcfg, 1, S, seed=9))})
    assert seen == {"fa": expect, "scan": tcfg.n_layers}


@pytest.mark.gpu
def test_card_prefill_matches_cpu_prefill():
    """Reduced Hymba at head_dim 64 in float32: the card (both kernels)
    against the CPU (plain versions), within 1e-3 (float32 in another
    summation order and exp2 in the kernel; the KV cache is bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = dataclasses.replace(T_ARCHS["hymba-1.5b"], dtype="float32",
                              head_dim=64, attn_chunk=2048)
    params = ttr.build_param_table(cfg).init(
        torch.Generator().manual_seed(0), device="cpu")
    toks = _t(_tokens(cfg, 2, 40, seed=1))
    cpu_last, cpu_cache = tdec.prefill(cfg, params, {"tokens": toks})
    dev_params = tree_map(lambda a: a.cuda(), params)
    last, cache = tdec.prefill(cfg, dev_params, {"tokens": toks.cuda()})
    torch.testing.assert_close(last.cpu(), cpu_last, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(cache["ssm"].cpu(), cpu_cache["ssm"],
                               rtol=1e-3, atol=1e-3)


def test_param_table_init_uses_the_generator():
    t = ParamTable()
    t.add("a/w", (4, 8))
    one = t.init(torch.Generator().manual_seed(3), device="cpu")
    two = t.init(torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(one["a"]["w"], two["a"]["w"])


def test_lm_entry_points_without_device_raise_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from repro_torch.configs.base import ShapeConfig as TShape
    cfg = T_ARCHS["hymba-1.5b"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.build_param_table(cfg).init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.ones(2, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.init_cache(cfg, TShape("d", 8, 1, "decode"))


# --------------------------------------------------------------------------
# prefill(S) + one decode step against one prefill(S + 1), at depth
# --------------------------------------------------------------------------

# a wider reduced Hymba: 5 heads over 1 KV head of 64, SSM state 16, a
# window wider than the prompt
WIDE = dict(d_model=320, n_heads=5, n_kv_heads=1, head_dim=64, d_ff=1100,
            vocab_size=2048, ssm_state=16, swa_window=1024,
            global_attn_every=8, attn_chunk=2048)


def _decode_gap(n_layers, S, dtype, seed=0):
    """Last logits of prefill(S) + decode_step(S) ("stepped") and of one
    prefill(S + 1) ("longer") in both packages, on the same weights and
    tokens. Returns the stepped and longer logits of each and prints the
    readings (run with ``-s`` to see them)."""
    from repro.configs import ARCHS as J_FULL
    from repro.configs.base import reduced as jreduced
    from repro_torch.configs.base import reduced as treduced
    jcfg = jreduced(J_FULL["hymba-1.5b"], n_layers=n_layers, dtype=dtype,
                    **WIDE)
    tcfg = treduced(T_FULL["hymba-1.5b"], n_layers=n_layers, dtype=dtype,
                    **WIDE)
    jp = jtr.build_param_table(jcfg).init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens(jcfg, 2, S + 1, seed)
    out = {}
    _, jc = jdec.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])},
                         max_len=S + 8)
    js, _ = jdec.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, S:]),
                             jnp.int32(S))
    jl, _ = jdec.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                         max_len=S + 8)
    out["ref"] = (_np(js[:, 0]), _np(jl))
    with torch.inference_mode():
        _, tc = tdec.prefill(tcfg, tp, {"tokens": _t(toks[:, :S])},
                             max_len=S + 8)
        ts, _ = tdec.decode_step(tcfg, tp, tc, _t(toks[:, S:]), S)
        tl, _ = tdec.prefill(tcfg, tp, {"tokens": _t(toks)}, max_len=S + 8)
    out["port"] = (_np(ts[:, 0].float()), _np(tl.float()))
    for who, (a, b) in out.items():
        print(f"{dtype} L={n_layers} S={S} {who}: stepped vs longer max "
              f"{np.abs(a - b).max():.4g}, rel L2 "
              f"{np.linalg.norm(a - b) / np.linalg.norm(b):.4g}")
    return out


def test_float32_decode_gap_at_depth_is_the_references():
    """float32 compute over 32 layers at S = 100. The one difference
    between the two orders is the bf16 KV cache: the decode step reads the
    prompt's k/v rounded, the longer prefill attends to them unrounded,
    and the difference grows with depth. The port's gap is the
    reference's within 10% (the same algorithm, float32 in another
    summation order), and its logits are the reference's within 5e-3 (32
    layers of float32 summation order, and k/v that may round to
    neighbouring bf16 values)."""
    out = _decode_gap(32, 100, "float32")
    (js, jl), (ts, tl) = out["ref"], out["port"]
    gap_j, gap_t = np.abs(js - jl).max(), np.abs(ts - tl).max()
    assert gap_j > 1e-2
    assert abs(gap_t - gap_j) <= 0.1 * gap_j
    np.testing.assert_allclose(ts, js, rtol=0, atol=5e-3)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=5e-3)


def test_bf16_decode_gap_at_depth_is_rounding_order():
    """bf16 compute over 32 layers at S = 100. The reference rounds the
    two orders at other places (XLA fuses and tiles a one-token step
    otherwise than a prefill), and a one-ulp difference in a layer grows
    through the random-weight stack: its own gap is past
    test_models.py's bar. The port's plain path rounds a row alike in
    both orders, and its bf16 KV cache holds bf16 k/v exactly, so its gap
    stays at 2% of the reference's or less."""
    out = _decode_gap(32, 100, "bfloat16")
    (js, jl), (ts, tl) = out["ref"], out["port"]
    gap_j, gap_t = np.abs(js - jl).max(), np.abs(ts - tl).max()
    assert not np.allclose(js, jl, **BF16_TOL)
    assert gap_t <= 0.02 * gap_j


def test_prompt_longer_than_the_window_keeps_the_ring_aligned():
    """A prompt of 21 tokens over a window of 16: prefill leaves position
    p of an SWA layer in ring slot p % 16, where the decode steps write,
    so three decode steps give one prefill(24)'s last logits (float32
    compute over the bf16 KV cache: CACHE_TOL). Keeping the last 16
    positions unrolled, as the reference does, evicts positions still in
    the window."""
    _jcfg, tcfg, _jp, tp = _pair("hymba-1.5b", seed=11)
    W = tcfg.swa_window
    toks = _t(_tokens(tcfg, 2, 24, seed=12))
    _, cache = tdec.prefill(tcfg, tp, {"tokens": toks[:, :21]}, max_len=24)
    swa = [lc for i, lc in enumerate(cache["layers"])
           if not ttr.is_global_layer(tcfg, i)]
    assert swa and all(tuple(lc["pos"].shape) == (2, W) for lc in swa)
    for lc in swa:
        assert lc["pos"][:, [p % W for p in range(5, 21)]].tolist() == \
            [list(range(5, 21))] * 2
    for pos in range(21, 24):
        logits, cache = tdec.decode_step(tcfg, tp, cache,
                                         toks[:, pos:pos + 1], pos)
    want, _ = tdec.prefill(tcfg, tp, {"tokens": toks})
    np.testing.assert_allclose(logits[:, 0].numpy(), want.numpy(),
                               **CACHE_TOL)
