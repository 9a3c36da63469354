"""The mixture-of-experts layer of the port (`repro_torch.models.moe`)
against the JAX package's (`repro.models.moe`) at reduced sizes on the
CPU, and the bounded draw of `ParamTable.init`.

Inputs are made with numpy from a seed. The dispatch (top-k experts,
places, keep mask, destinations) must be the reference's to the bit; the
layer's output within 1e-5 and its auxiliary loss within 1e-6 in
float32 (the same algorithm in another summation order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED_ARCHS as J_ARCHS
from repro.models import moe as jmoe
from repro_torch.configs import ARCHS as T_FULL
from repro_torch.configs import REDUCED_ARCHS as T_ARCHS
from repro_torch.kernels import ops
from repro_torch.models import decoding as tdec
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr

torch.backends.cuda.matmul.allow_tf32 = False

MOE = ["moonshot-v1-16b-a3b", "mixtral-8x7b"]
# (label, capacity_factor, deterministic_capacity, router columns tied)
CASES = [("drop_free", None, 0, False),
         ("factor_0.5_drops", 0.5, 0, False),
         ("deterministic_2", None, 2, False),
         ("router_ties", None, 0, True)]
Y_TOL = dict(rtol=1e-5, atol=1e-5)


def _layer(name, factor, tied, seed=0, B=2, S=12):
    """One layer's configs (float32 compute), weights and input."""
    over = dict(dtype="float32")
    if factor is not None:
        over["capacity_factor"] = factor
    jcfg = dataclasses.replace(J_ARCHS[name], **over)
    tcfg = dataclasses.replace(T_ARCHS[name], **over)
    rng = np.random.default_rng(seed)
    d, E, f = jcfg.d_model, jcfg.n_experts, jcfg.expert_d_ff
    p = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
         "w_gate": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    if tied:
        # experts 0, 1 and 2 share a router column: every token ties
        # among them, at the top-k boundary whenever they lead
        p["router"][:, 1] = p["router"][:, 0]
        p["router"][:, 2] = p["router"][:, 0]
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    return jcfg, tcfg, p, x


def _ref_dispatch(cfg, router, x, deterministic_capacity=0):
    """The reference's dispatch, `repro.models.moe.moe_ffn`'s lines from
    the router product to ``dest``, in JAX: (idx, pos, keep, dest)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = deterministic_capacity or max(
        int(cfg.capacity_factor * k * T / E), 1)
    xt = x.reshape(T, d)
    logits = xt.astype(jnp.float32) @ router.astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _gate_vals, idx = jax.lax.top_k(probs, k)
    flat_e = idx.reshape(-1)
    oh = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = ((jnp.cumsum(oh, axis=0) - 1) * oh).sum(-1)
    keep = pos < C
    dest = flat_e * C + jnp.minimum(pos, C - 1)
    return [np.asarray(a) for a in (idx, pos, keep, dest)]


@pytest.mark.parametrize("label,factor,det,tied", CASES)
@pytest.mark.parametrize("name", MOE)
def test_dispatch_is_the_references_bit_for_bit(name, label, factor, det,
                                                tied):
    jcfg, tcfg, p, x = _layer(name, factor, tied)
    want = _ref_dispatch(jcfg, jnp.asarray(p["router"]), jnp.asarray(x),
                         det)
    r = tmoe.route(tcfg, torch.from_numpy(p["router"]),
                   torch.from_numpy(x.reshape(-1, x.shape[-1])), det)
    got = [r.idx, r.pos, r.keep, r.dest]
    for w, g, what in zip(want, got, ("idx", "pos", "keep", "dest")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)
    dropped = 1 - float(r.keep.float().mean())
    if label in ("factor_0.5_drops", "deterministic_2"):
        assert dropped > 0.2
    else:
        assert dropped == 0.0
    if tied:
        probs = r.probs.numpy()
        assert (probs[:, 0] == probs[:, 1]).all()
        assert (probs[:, 1] == probs[:, 2]).all()
        # at least one token picks two of the tied experts, lower first
        assert any(list(row) == [0, 1] for row in r.idx.tolist())


@pytest.mark.parametrize("label,factor,det,tied", CASES)
@pytest.mark.parametrize("name", MOE)
def test_moe_ffn_matches_reference(name, label, factor, det, tied):
    jcfg, tcfg, p, x = _layer(name, factor, tied, seed=1)
    jy, jaux = jmoe.moe_ffn(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), deterministic_capacity=det)
    ty, taux = tmoe.moe_ffn(tcfg, {k: torch.from_numpy(v)
                                   for k, v in p.items()},
                            torch.from_numpy(x), deterministic_capacity=det)
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **Y_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", MOE)
def test_moe_ffn_in_bf16_matches_reference(name):
    """bf16 compute: both round the expert products and the combine to
    bf16 at the same places; tests/test_models.py's bf16 bar."""
    jcfg, tcfg, p, x = _layer(name, None, False, seed=2)
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    jy, jaux = jmoe.moe_ffn(jcfg, jp, jnp.asarray(x, jnp.bfloat16))
    ty, taux = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32),
                               rtol=0.1, atol=0.15)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-3)


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3],
                          [0.25, 0.25, 0.25, 0.25],
                          [0.4, 0.1, 0.4, 0.1]])
    vals, idx = tmoe.top_k(probs, 2)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(want_idx).tolist() == \
        [[1, 2], [0, 1], [0, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


@pytest.mark.parametrize("T,want", [(8, 1), (8 * 1024, 960), (2, 1)])
def test_capacity_of_moonlight_at_decode_and_prefill(T, want):
    """C = int(1.25 * 6 * T / 64), at least 1: one place per expert for a
    decode step of 8 rows, 960 for a prefill of 8 x 1024 tokens."""
    assert tmoe.capacity(T_FULL["moonshot-v1-16b-a3b"], T) == want


@pytest.mark.parametrize("name,S,expect", [
    ("moonshot-v1-16b-a3b", 24, 2), ("mixtral-8x7b", 16, 2),
    ("mixtral-8x7b", 20, 0)])
def test_moe_prefill_routes_attention_as_the_dense_layers(monkeypatch, name,
                                                          S, expect):
    """Reduced Moonlight (no window) sends every layer's attention to
    ops.flash_attention; reduced Mixtral (window 16, no global layers)
    does at S <= window and takes the plain windowed path beyond."""
    tcfg = T_ARCHS[name]
    params = ttr.build_param_table(tcfg).init(
        torch.Generator().manual_seed(0), device="cpu")
    calls = []
    real = ops.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    toks = torch.randint(0, tcfg.vocab_size, (2, S),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    last, cache = tdec.prefill(tcfg, params, {"tokens": toks})
    assert len(calls) == expect
    assert tuple(last.shape) == (2, tcfg.vocab_size)
    assert bool(torch.isfinite(last.float()).all())


# --------------------------------------------------------------------------
# ParamTable.init: bounded draws
# --------------------------------------------------------------------------

def test_param_table_init_draws_in_bounded_pieces(monkeypatch):
    """With DRAW_ELEMS at 100, no float32 draw is larger than 100
    elements (a (3, 7, 40) leaf takes nine); every leaf has its declared
    shape, storage type and scale; the same seed gives the same leaves,
    drawn from the generator."""
    t = tlayers.ParamTable()
    t.add("blocks/w", (3, 7, 40))
    t.add("blocks/v", (5, 9))
    t.add("embed", (64, 8), init="embed", scale=0.02)
    t.add("norm", (8,), init="ones")
    monkeypatch.setattr(tlayers, "DRAW_ELEMS", 100)
    sizes = []
    real = torch.randn

    def spy(*a, **kw):
        out = real(*a, **kw)
        sizes.append(out.numel())
        assert out.dtype == torch.float32 and kw["generator"] is not None
        return out
    monkeypatch.setattr(torch, "randn", spy)
    params = t.init(torch.Generator().manual_seed(4), device="cpu",
                    dtype=torch.bfloat16)
    assert max(sizes) <= 100
    assert sum(sizes) == 3 * 7 * 40 + 5 * 9 + 64 * 8
    # 840 = 8 x 100 + 40, then 45, then 512 = 5 x 100 + 12
    assert sizes.count(100) == 8 + 5
    for path, (shape, kind, scale) in t.defs.items():
        leaf = params
        for part in path.split("/"):
            leaf = leaf[part]
        assert tuple(leaf.shape) == shape and leaf.dtype == torch.bfloat16
        if kind == "ones":
            assert bool((leaf == 1).all())
        else:
            std = float(leaf.float().std())
            assert abs(std / scale - 1) < 0.15, (path, std, scale)
    again = t.init(torch.Generator().manual_seed(4), device="cpu",
                   dtype=torch.bfloat16)
    other = t.init(torch.Generator().manual_seed(5), device="cpu",
                   dtype=torch.bfloat16)
    assert torch.equal(params["blocks"]["w"], again["blocks"]["w"])
    assert not torch.equal(params["blocks"]["w"], other["blocks"]["w"])


def test_param_table_init_of_moonlight_declares_its_experts():
    """The full config's table: 28.06 B parameters, the expert leaves of
    (48, 64, 2048, 1408) and (48, 64, 1408, 2048), no dense MLP."""
    t = ttr.build_param_table(T_FULL["moonshot-v1-16b-a3b"])
    shapes = {k: v[0] for k, v in t.defs.items()}
    assert shapes["blocks/moe/w_gate"] == (48, 64, 2048, 1408)
    assert shapes["blocks/moe/w_down"] == (48, 64, 1408, 2048)
    assert shapes["blocks/moe/router"] == (48, 2048, 64)
    assert not any(k.startswith("blocks/mlp") for k in shapes)
    n = sum(int(np.prod(s)) for s in shapes.values())
    assert round(n / 1e9, 2) == 28.06
    assert round(n * 2 / 2 ** 30, 1) == 52.3
