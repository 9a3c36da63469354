"""The last three LM families of the port against the JAX package at
reduced sizes on the CPU: RWKV-6 (`repro_torch.models.rwkv`), Whisper's
encoder-decoder and the Qwen2-VL frontend (M-RoPE, vision embeddings),
piece by piece; `tests/test_torch_lm.py` holds the whole families.

Weights come from the reference's `ParamTable.init` and are carried over
with `params_from_numpy`; inputs are made with numpy from a seed. Float32
compute: the two packages run the same float32 algorithm in another
summation order (F32_TOL).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import REDUCED_ARCHS as J_ARCHS
from repro.models import decoding as jdec
from repro.models import layers as jlayers
from repro.models import rwkv as jrwkv
from repro.models import transformer as jtr
from repro_torch.configs import REDUCED_ARCHS as T_ARCHS
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import decoding as tdec
from repro_torch.models import layers as tlayers
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import params_from_numpy, tree_map

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32_TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = ["qwen2-vl-7b", "rwkv6-3b", "whisper-large-v3"]


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(name, seed=1, **over):
    jcfg = dataclasses.replace(J_ARCHS[name], dtype="float32", **over)
    tcfg = dataclasses.replace(T_ARCHS[name], dtype="float32", **over)
    jp = jtr.build_param_table(jcfg).init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def vlm_positions(B: int, S: int, n_vision: int) -> np.ndarray:
    """(B,S,3) M-RoPE positions: the vision block at (t, h, w) = (0, row,
    col) of a square grid, the text at its own index on all three columns
    (so a decode step at position p continues it)."""
    side = int(round(n_vision ** 0.5))
    pos = np.broadcast_to(np.arange(S)[None, :, None], (B, S, 3)).copy()
    i = np.arange(n_vision)
    pos[:, :n_vision] = np.stack([0 * i, i // side, i % side], -1)
    return pos.astype(np.int32)


def family_batch(cfg, B: int, S: int, seed: int) -> dict:
    """Tokens, and what the family's stub frontend gives: vision
    embeddings N(0, 0.02) and M-RoPE positions (VLM), frames N(0, 0.02)
    of the encoder's length (Whisper)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = (rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)) * .02).astype(np.float32)
        batch["positions"] = vlm_positions(B, S, cfg.n_vision_tokens)
    if cfg.enc_dec:
        batch["enc_frames"] = (rng.standard_normal(
            (B, cfg.enc_len, cfg.d_model)) * .02).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: _t(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# elementary layers
# --------------------------------------------------------------------------

def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 997).astype(np.float32)
    got = tlayers.activation("gelu")(_t(x))
    np.testing.assert_allclose(got.numpy(),
                               _np(jlayers.activation("gelu")(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    exact = F.gelu(_t(x))
    assert float((got - exact).abs().max()) > 1e-4   # not the erf form
    for name in ("silu", "relu"):
        np.testing.assert_allclose(
            tlayers.activation(name)(_t(x)).numpy(),
            _np(jlayers.activation(name)(jnp.asarray(x))), rtol=1e-6,
            atol=1e-6)


@pytest.mark.parametrize("dim", [16, 64, 1280])
def test_both_sinusoidal_layouts_are_the_references(dim):
    """The decoder's [sin | cos] at positions of Whisper's 448-token
    text context, and the encoder's interleaved float64-NumPy table
    (exactly). The decoder's frequencies are float32 exps, in which XLA
    and torch may differ by an ulp: an angle of p radians then moves by
    up to p 2^-23 (5e-5 at p = 447)."""
    pos = np.array([[0, 3, 17], [447, 255, 7]], np.int32)
    np.testing.assert_allclose(
        tlayers.sinusoidal_at(_t(pos), dim).numpy(),
        _np(jlayers.sinusoidal_at(jnp.asarray(pos), dim)), rtol=0,
        atol=1e-4)
    table = tlayers.sinusoidal_positions(1500, dim, torch.float32, "cpu")
    np.testing.assert_array_equal(
        table.numpy(), _np(jlayers.sinusoidal_positions(1500, dim)))


def test_sinusoidal_layouts_differ():
    """The two layouts are not one another: half of the columns move."""
    at = tlayers.sinusoidal_at(torch.arange(8), 16)
    table = tlayers.sinusoidal_positions(8, 16, torch.float32, "cpu")
    torch.testing.assert_close(at[:, 0], table[:, 0])
    assert not torch.allclose(at, table)


@pytest.mark.parametrize("sections,theta", [((16, 24, 24), 1e6),
                                            ((4, 2, 2), 1e6),
                                            ((), 1e4)])
def test_rope_angles_with_three_distinct_position_columns(sections, theta):
    """M-RoPE: band i reads column i % 3; with three distinct columns a
    wrong split moves the angles. Without sections, plain RoPE."""
    half = sum(sections) or 32
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 2000, (2, 9, 3) if sections else (2, 9)) \
        .astype(np.int32)
    got = tlayers.rope_angles(_t(pos), 2 * half, theta, sections)
    want = jlayers.rope_angles(jnp.asarray(pos), 2 * half, theta, sections)
    assert tuple(got.shape) == want.shape == (2, 9, half)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-3)
    if sections:
        # each band is its column's plain RoPE band
        start = 0
        for i, sec in enumerate(sections):
            plain = tlayers.rope_angles(_t(pos[..., i]), 2 * half, theta)
            torch.testing.assert_close(got[..., start:start + sec],
                                       plain[..., start:start + sec])
            start += sec


# --------------------------------------------------------------------------
# RWKV-6
# --------------------------------------------------------------------------

def _rwkv_layer(seed=2):
    """Layer 0's RWKV parameters of reduced rwkv6 in both packages, with
    the token-shift mixes, decay base, bonus and norm gain drawn (the
    init makes them 0 or 1, which hides the token shift)."""
    jcfg, tcfg, jp, _ = _pair("rwkv6-3b", seed=seed)
    j_lp = jax.tree.map(lambda a: np.asarray(a[0]), jp["blocks"]["rwkv"])
    rng = np.random.default_rng(seed)
    for name in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "cmix_k",
                 "cmix_r"):
        j_lp[name] = rng.random(j_lp[name].shape).astype(np.float32)
    for name in ("w0", "u_bonus"):
        j_lp[name] = (rng.standard_normal(j_lp[name].shape) * 0.5) \
            .astype(np.float32)
    j_lp["ln_g"] = (1 + 0.1 * rng.standard_normal(j_lp["ln_g"].shape)) \
        .astype(np.float32)
    t_lp = params_from_numpy(j_lp, "cpu")
    return jcfg, tcfg, jax.tree.map(jnp.asarray, j_lp), t_lp


def _x(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(
        np.float32)


@pytest.mark.parametrize("carried", [False, True])
def test_time_mix_matches_reference(carried):
    """Over a sequence, from zeros or from a carried state and token:
    the output, the final float32 state and the last input."""
    jcfg, tcfg, j_lp, t_lp = _rwkv_layer()
    x = _x(jcfg, 2, 11, seed=3)
    st = xp = None
    if carried:
        rng = np.random.default_rng(4)
        H, D = jcfg.n_heads, jcfg.resolved_head_dim
        st = rng.standard_normal((2, H, D, D)).astype(np.float32)
        xp = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    jy, jst, jlast = jrwkv.time_mix(
        jcfg, j_lp, jnp.asarray(x), None if st is None else jnp.asarray(st),
        None if xp is None else jnp.asarray(xp))
    state = None if st is None else _t(st)
    ty, tst, tlast = trwkv.time_mix(tcfg, t_lp, _t(x), state,
                                    None if xp is None else _t(xp))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **F32_TOL)
    np.testing.assert_allclose(tst.numpy(), _np(jst), **F32_TOL)
    np.testing.assert_array_equal(tlast.numpy(), _np(jlast))
    assert tst.dtype == torch.float32
    if carried:                                  # the state given is kept
        np.testing.assert_array_equal(state.numpy(), st)


def test_time_mix_stepwise_continues_the_sequence():
    """Seven tokens, then four single steps from the carried state and
    last token, in both packages: each step within F32_TOL of the
    reference's, and the port's steps equal its own 11-token pass."""
    jcfg, tcfg, j_lp, t_lp = _rwkv_layer(seed=5)
    x = _x(jcfg, 2, 11, seed=6)
    full_y, full_st, _ = trwkv.time_mix(tcfg, t_lp, _t(x))
    _, jst, jlast = jrwkv.time_mix(jcfg, j_lp, jnp.asarray(x[:, :7]))
    _, tst, tlast = trwkv.time_mix(tcfg, t_lp, _t(x[:, :7]))
    for t in range(7, 11):
        jy, jst, jlast = jrwkv.time_mix(jcfg, j_lp,
                                        jnp.asarray(x[:, t:t + 1]), jst,
                                        jlast)
        ty, tst, tlast = trwkv.time_mix(tcfg, t_lp, _t(x[:, t:t + 1]), tst,
                                        tlast)
        np.testing.assert_allclose(ty.numpy(), _np(jy), **F32_TOL)
        np.testing.assert_allclose(tst.numpy(), _np(jst), **F32_TOL)
        torch.testing.assert_close(ty[:, 0], full_y[:, t], **F32_TOL)
    torch.testing.assert_close(tst, full_st, **F32_TOL)


@pytest.mark.parametrize("carried", [False, True])
def test_channel_mix_matches_reference(carried):
    jcfg, tcfg, j_lp, t_lp = _rwkv_layer(seed=7)
    x = _x(jcfg, 2, 9, seed=8)
    xp = _x(jcfg, 2, 1, seed=9)[:, 0] if carried else None
    jy, jlast = jrwkv.channel_mix(jcfg, j_lp, jnp.asarray(x),
                                  None if xp is None else jnp.asarray(xp))
    ty, tlast = trwkv.channel_mix(tcfg, t_lp, _t(x),
                                  None if xp is None else _t(xp))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **F32_TOL)
    np.testing.assert_array_equal(tlast.numpy(), _np(jlast))
    # stepwise: token t from token t-1 equals the sequence's row t
    for t in range(1, 9):
        step, _ = trwkv.channel_mix(tcfg, t_lp, _t(x[:, t:t + 1]),
                                    _t(x[:, t - 1]))
        torch.testing.assert_close(step[:, 0], ty[:, t], **F32_TOL)


def test_group_norm_uses_the_population_variance():
    rng = np.random.default_rng(10)
    H, Dh = 4, 16
    y = rng.standard_normal((2, 5, H * Dh)).astype(np.float32) * 3 + 1
    g = rng.standard_normal(H * Dh).astype(np.float32)
    got = trwkv._group_norm(_t(y), _t(g), H, Dh)
    np.testing.assert_allclose(
        got.numpy(), _np(jrwkv._group_norm(jnp.asarray(y), jnp.asarray(g),
                                           H, Dh)), **F32_TOL)
    heads = got.reshape(2, 5, H, Dh) / _t(g).reshape(H, Dh)
    torch.testing.assert_close(heads.var(-1, unbiased=False),
                               torch.full((2, 5, H), 1.0), rtol=1e-3,
                               atol=1e-3)


def test_rwkv_prefill_state_equals_prefill_plus_steps():
    """Reduced rwkv6 in bf16 with drawn token-shift mixes: the float32
    state and the token-shift inputs after prefill(S) + k decode steps
    are those of prefill(S + k), within float32 summation order. (In
    float32 compute the bf16 cache of the token-shift inputs rounds what
    the longer prefill keeps unrounded, and the states part by ~1e-2.)"""
    _jcfg, tcfg, _jp, tp = _pair("rwkv6-3b", seed=11)
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    rng = np.random.default_rng(11)
    for name in ("mix_r", "mix_k", "mix_w", "cmix_k"):
        tp["blocks"]["rwkv"][name] = torch.from_numpy(
            rng.random(tuple(tp["blocks"]["rwkv"][name].shape))
            .astype(np.float32))
    toks = _t(rng.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32))
    _, cache = tdec.prefill(tcfg, tp, {"tokens": toks[:, :8]})
    for pos in range(8, 12):
        _, cache = tdec.decode_step(tcfg, tp, cache, toks[:, pos:pos + 1],
                                    pos)
    _, want = tdec.prefill(tcfg, tp, {"tokens": toks})
    torch.testing.assert_close(cache["state"], want["state"], **F32_TOL)
    for name in ("x_tm", "x_cm"):
        assert cache[name].dtype == torch.bfloat16
        torch.testing.assert_close(cache[name], want[name], rtol=2 ** -7,
                                   atol=1e-6)


# --------------------------------------------------------------------------
# Whisper: encoder, cross-attention cache, routes
# --------------------------------------------------------------------------

def test_encode_matches_reference():
    jcfg, tcfg, jp, tp = _pair("whisper-large-v3", seed=12)
    frames = family_batch(jcfg, 2, 4, seed=13)["enc_frames"]
    want = jtr.encode(jcfg, jtr.cast_params(jcfg, jp), jnp.asarray(frames))
    got = ttr.encode(tcfg, ttr.cast_params(tcfg, tp), _t(frames))
    assert tuple(got.shape) == want.shape == (2, tcfg.enc_len, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)


def test_cross_attention_cache_matches_reference():
    """prefill's xk/xv: every layer's keys and values of the encoder's
    output, within one bf16 rounding of the reference's; position slots
    of the self-attention cache as the reference's."""
    jcfg, tcfg, jp, tp = _pair("whisper-large-v3", seed=14)
    batch = family_batch(jcfg, 2, 6, seed=15)
    _, jc = jdec.prefill(jcfg, jp, _jax(batch), max_len=10)
    _, tc = tdec.prefill(tcfg, tp, _torch(batch), max_len=10)
    for name in ("xk", "xv"):
        assert tc[name].dtype == torch.bfloat16
        assert tuple(tc[name].shape) == jc[name].shape == (
            tcfg.n_layers, 2, tcfg.enc_len, tcfg.n_kv_heads,
            tcfg.resolved_head_dim)
        np.testing.assert_allclose(tc[name].float().numpy(), _np(jc[name]),
                                   rtol=2 ** -7, atol=1e-6)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_whisper_self_and_cross_attention_take_the_kernel_route(
        monkeypatch):
    """Reduced Whisper, 6 decoder tokens over 16 encoder frames: every
    encoder layer (full mask), every decoder layer's self-attention
    (causal) and, since the kernel takes fewer queries than keys, its
    cross-attention (6 queries over 16 keys, a full mask) go through
    ops.flash_attention; a causal call of 6 queries over 16 keys at
    offset 0 still takes the plain route (the kernel aligns the mask
    bottom-right)."""
    _jcfg, tcfg, _jp, tp = _pair("whisper-large-v3", seed=16)
    seen = []
    real = ops.flash_attention

    def counted(q, k, v, *, causal=True):
        seen.append((q.shape[2], k.shape[2], causal))
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(ops, "flash_attention", counted)
    tdec.prefill(tcfg, tp, _torch(family_batch(tcfg, 2, 6, seed=17)))
    Se = tcfg.enc_len
    assert seen == ([(Se, Se, False)] * tcfg.enc_layers
                    + [(6, 6, True), (6, Se, False)] * tcfg.n_layers)
    assert not tattn.uses_kernel(6, Se, window=0, q_offset=0,
                                 is_global=None)
    assert tattn.uses_kernel(6, Se, window=0, q_offset=0, is_global=None,
                             causal=False)
    assert tattn.uses_kernel(Se, Se, window=0, q_offset=0, is_global=None)


def test_vlm_vision_embeds_replace_the_first_tokens():
    """embed_inputs: the first n_vision_tokens rows are the vision
    embeddings, the rest the tokens' embeddings; positions pass through;
    no sinusoidal term (M-RoPE)."""
    jcfg, tcfg, jp, tp = _pair("qwen2-vl-7b", seed=18)
    batch = family_batch(jcfg, 2, 9, seed=19)
    jx, jpos = jtr.embed_inputs(jcfg, jtr.cast_params(jcfg, jp),
                                _jax(batch))
    tx, tpos = ttr.embed_inputs(tcfg, ttr.cast_params(tcfg, tp),
                                _torch(batch))
    np.testing.assert_array_equal(tx.numpy(), _np(jx))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    n = tcfg.n_vision_tokens
    np.testing.assert_array_equal(tx[:, :n].numpy(), batch["vision_embeds"])
    np.testing.assert_array_equal(
        tx[:, n:].numpy(),
        tp["embed"]["tokens"][_t(batch["tokens"][:, n:]).long()].numpy())


# --------------------------------------------------------------------------
# card against CPU
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", FAMILIES)
def test_card_prefill_and_decode_match_cpu(name):
    """Each reduced family in float32, the card (K3 where the path takes
    it) against the CPU (plain versions): prefill's last logits and two
    decode steps within 1e-3 (float32 in another summation order and
    exp2 in the kernel; the KV cache is bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = dataclasses.replace(T_ARCHS[name], dtype="float32")
    params = ttr.build_param_table(cfg).init(
        torch.Generator().manual_seed(0), device="cpu")
    batch = _torch(family_batch(cfg, 2, 12, seed=20))
    dev_params = tree_map(lambda a: a.cuda(), params)
    dev_batch = {k: v.cuda() for k, v in batch.items()}
    out = {}
    for who, p, b in (("cpu", params, batch), ("card", dev_params,
                                                dev_batch)):
        pre = {k: (v[:, :10] if k in ("tokens", "positions") else v)
               for k, v in b.items()}
        last, cache = tdec.prefill(cfg, p, pre, max_len=12)
        logits = [last]
        for pos in (10, 11):
            step, cache = tdec.decode_step(cfg, p, cache,
                                           b["tokens"][:, pos:pos + 1], pos)
            logits.append(step[:, 0])
        out[who] = [t.cpu() for t in logits]
    for card, cpu in zip(out["card"], out["cpu"]):
        torch.testing.assert_close(card, cpu, rtol=1e-3, atol=1e-3)
