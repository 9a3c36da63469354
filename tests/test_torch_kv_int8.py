"""The int8 KV cache of the port (`repro_torch.models.decoding`, the
stacked families) against the reference's (`repro.models.decoding`) at
reduced sizes on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED_ARCHS as J_ARCHS
from repro.configs.base import ShapeConfig as JShape
from repro.models import decoding as jdec
from repro.models import transformer as jtr
from repro_torch.configs import REDUCED_ARCHS as T_ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import decoding as tdec
from repro_torch.models.layers import params_from_numpy
from repro_torch.models.layers import tree_leaves as leaves

# the stacked families: dense, VLM, MoE, Whisper's decoder
STACKED = ["granite-3-2b", "qwen2-vl-7b", "mixtral-8x7b",
           "whisper-large-v3"]


def _pair(name, dtype, seed=0):
    jcfg = dataclasses.replace(J_ARCHS[name], dtype=dtype)
    tcfg = dataclasses.replace(T_ARCHS[name], dtype=dtype)
    jp = jtr.build_param_table(jcfg).init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def test_quantize_kv_is_the_references_bit_for_bit():
    """int8 values and bf16 scales equal, from float32 and bf16 inputs,
    rows of all zeros (the 1e-8 floor) and exact halves (round half to
    even) included; dequantized values equal too."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 2, 16)) * 4).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 1, 1] = np.arange(16) - 7.5          # scale 7.5 / 127: halves
    for dt_t, dt_j in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        tq, ts = tdec._quantize_kv(torch.from_numpy(x).to(dt_t))
        jq, js = jdec._quantize_kv(jnp.asarray(x, dt_j))
        assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.float().numpy(),
                                      np.asarray(js, np.float32))
        np.testing.assert_array_equal(
            tdec._dequantize_kv(tq, ts).float().numpy(),
            np.asarray(jdec._dequantize_kv(jq, js), np.float32))


def test_int8_cache_layout_is_the_references_and_only_stacked():
    for name in STACKED:
        jc = jdec.init_cache(J_ARCHS[name], JShape("d", 24, 2, "decode"),
                             kv_int8=True)
        tc = tdec.init_cache(T_ARCHS[name], ShapeConfig("d", 24, 2,
                                                        "decode"),
                             "cpu", kv_int8=True)
        assert sorted(tc) == sorted(jc)
        for a, b in zip(leaves(tc), jax.tree.leaves(jc)):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).replace("torch.", "") == str(b.dtype)
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
    for name in ("hymba-1.5b", "rwkv6-3b"):
        with pytest.raises(ValueError, match="int8"):
            tdec.init_cache(T_ARCHS[name], ShapeConfig("d", 8, 2, "decode"),
                            "cpu", kv_int8=True)


def test_int8_kv_cache_decode_parity():
    """The twin of tests/test_substrate.py's: reduced granite (bf16), 6
    decode steps from empty caches, the int8 cache's logits within 0.3
    of the bf16 cache's."""
    _, cfg, _, params = _pair("granite-3-2b", "bfloat16")
    shape = ShapeConfig("d", 16, 2, "decode")
    rng = np.random.default_rng(0)
    c_bf = tdec.init_cache(cfg, shape, "cpu")
    c_i8 = tdec.init_cache(cfg, shape, "cpu", kv_int8=True)
    for pos in range(6):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1))
                               .astype(np.int32))
        l1, c_bf = tdec.decode_step(cfg, params, c_bf, tok, pos)
        l2, c_i8 = tdec.decode_step(cfg, params, c_i8, tok, pos)
        assert float((l1.float() - l2.float()).abs().max()) < 0.3
    assert c_i8["k"].dtype == torch.int8 and bool((c_i8["k_scale"] > 0)
                                                  .any())


@pytest.mark.parametrize("name", STACKED)
def test_int8_decode_matches_the_references_int8_decode(name):
    """float32 compute, 18 steps from an empty int8 cache, past the
    reduced window (16 slots for the SWA families), both packages: the
    logits within 2e-2 (a k or v a float32 ulp apart may round to
    neighbouring int8 steps, as a bf16 cache's entries may), and the
    int8 entries of the cache mostly equal."""
    jcfg, tcfg, jp, tp = _pair(name, "float32")
    shape = (20, 2)
    jc = jdec.init_cache(jcfg, JShape("d", *shape, "decode"), kv_int8=True)
    tc = tdec.init_cache(tcfg, ShapeConfig("d", *shape, "decode"), "cpu",
                         kv_int8=True)
    if tcfg.enc_dec:                      # an encoder output to attend to
        rng = np.random.default_rng(3)
        xk = rng.standard_normal(jc["xk"].shape).astype(np.float32)
        xv = rng.standard_normal(jc["xv"].shape).astype(np.float32)
        jc = dict(jc, xk=jnp.asarray(xk, jnp.bfloat16),
                  xv=jnp.asarray(xv, jnp.bfloat16))
        tc["xk"] = torch.from_numpy(xk).bfloat16()
        tc["xv"] = torch.from_numpy(xv).bfloat16()
    rng = np.random.default_rng(1)
    for pos in range(18):
        tok = rng.integers(0, tcfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jdec.decode_step(jcfg, jp, jc, jnp.asarray(tok),
                                  jnp.int32(pos))
        tl, tc = tdec.decode_step(tcfg, tp, tc, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-2,
                                   atol=2e-2)
    same = (tc["k"].numpy() == np.asarray(jc["k"])).mean()
    assert same > 0.99
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("name", ["granite-3-2b", "qwen2-vl-7b"])
def test_batch_server_on_an_int8_cache_gives_each_request_its_tokens(name):
    """Three requests through 2 slots of an int8-cache server: each gets
    the tokens it gets alone in a fresh int8-cache server (the step
    writes only its row's entries and scales, admission clears them); on
    these prompts they are also the bf16 cache's tokens (REQUEST0's for
    qwen2-vl, tests/test_torch_lm_serve.py)."""
    from test_torch_lm_serve import MAX_NEW, REQUEST0, _prompts
    _, tcfg, _, tp = _pair(name, "float32")
    prompts = _prompts(tcfg, 3)

    def serve(ps, kv_int8):
        reqs = [tserve.Request(i, p, MAX_NEW) for i, p in enumerate(ps)]
        tserve.BatchServer(tcfg, tp, slots=2, device="cpu",
                           kv_int8=kv_int8).run(reqs)
        return [r.out for r in reqs]

    shared = serve(prompts, True)
    alone = [serve([p], True)[0] for p in prompts]
    assert shared == alone
    assert shared == serve(prompts, False)
    if name in REQUEST0:
        assert shared[0] == REQUEST0[name][0]


def test_a_prefill_cache_quantized_decodes_like_the_bf16_one():
    """quantize_cache of a prefill's cache (reduced Qwen2-VL, bf16): each
    slot's int8 values and scales are _quantize_kv's, positions kept;
    four decode steps from it stay within 0.3 of the bf16 cache's
    logits (the twin test's bar). The families without an int8 form
    raise."""
    from test_torch_families import family_batch
    _, cfg, _, params = _pair("qwen2-vl-7b", "bfloat16")
    batch = family_batch(cfg, 2, 16, seed=4)
    prompt = {k: torch.from_numpy(v[:, :12] if k == "positions" else v)
              for k, v in batch.items()}
    prompt["tokens"] = prompt["tokens"][:, :12]
    prompt["vision_embeds"] = prompt["vision_embeds"].bfloat16()
    _, bf = tdec.prefill(cfg, params, prompt, max_len=16)
    i8 = tdec.quantize_cache(cfg, dict(bf))
    q, sc = tdec._quantize_kv(bf["k"])
    assert torch.equal(i8["k"], q) and torch.equal(i8["k_scale"], sc)
    assert i8["v"].dtype == torch.int8 and torch.equal(i8["pos"], bf["pos"])
    for pos in range(12, 16):
        tok = torch.from_numpy(batch["tokens"][:, pos:pos + 1])
        l1, bf = tdec.decode_step(cfg, params, bf, tok, pos)
        l2, i8 = tdec.decode_step(cfg, params, i8, tok, pos)
        assert float((l1.float() - l2.float()).abs().max()) < 0.3
    for name in ("hymba-1.5b", "rwkv6-3b"):
        with pytest.raises(ValueError, match="int8"):
            tdec.quantize_cache(T_ARCHS[name], {})


def test_clear_row_empties_an_int8_rows_scales():
    cfg = T_ARCHS["granite-3-2b"]
    c = tdec.init_cache(cfg, ShapeConfig("d", 8, 3, "decode"), "cpu",
                        kv_int8=True)
    for name in ("k_scale", "v_scale"):
        c[name].fill_(1.0)
    c["pos"].fill_(4)
    tdec.clear_row(cfg, c, 1)
    for name in ("k_scale", "v_scale"):
        assert float(c[name][:, 1].abs().sum()) == 0
        assert bool((c[name][:, [0, 2]] == 1).all())
    assert (c["pos"][1] == -1).all() and (c["pos"][0] == 4).all()
