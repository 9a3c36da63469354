"""The port's LM analysis tools (`repro_torch.launch.roofline`,
`launch.op_profile`, `launch.dryrun`) against the JAX package's
`repro.launch.roofline` and `repro.launch.hlo_profile` on the CPU.

The roofline arithmetic is held equal to the reference's under the
reference's constants (patched into the port's module). The op profile
counts a step on meta tensors; its products are held equal to what
`hlo_profile.analyze` reads from the reference's compiled HLO of the same
functions, and of the same reduced steps under plain ``jax.jit``: exact
where both packages run the same products, with each known difference
named in the test.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import REDUCED_ARCHS as J_ARCHS
from repro.configs.base import ShapeConfig as JShape
from repro.launch import hlo_profile
from repro.launch import roofline as jroof
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro_torch.configs import REDUCED_ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun, op_profile, roofline
from repro_torch.models.layers import tree_leaves

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture
def reference_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(roofline, name, getattr(jroof, name))


def _record(arch, shape, mesh, kind, status="ok", **over):
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "kind": kind,
           "rules": "baseline", "status": status, "flops": 3.1e15,
           "collective_bytes": 2.5e10, "collective_wire_bytes": 4.0e10,
           "memory": {"argument_size_bytes": 7.0e9,
                      "output_size_bytes": 6.5e9,
                      "temp_size_bytes": 2.0e10}}
    rec.update(over)
    return rec


RECORDS = [
    _record("granite-3-2b", "train_4k", "16x16", "train"),
    _record("qwen1.5-110b", "prefill_32k", "2x16x16", "prefill",
            flops=9.9e13, collective_bytes=0.0),
    _record("moonshot-v1-16b-a3b", "decode_32k", "16x16", "decode",
            flops=1.0e11, memory={"argument_size_bytes": 3.0e10,
                                  "output_size_bytes": None,
                                  "temp_size_bytes": 1.0e8}),
    _record("rwkv6-3b", "long_500k", "2x16x16", "decode",
            collective_bytes=9.0e12),
    _record("whisper-large-v3", "train_4k", "16x16", "train",
            status="error"),
]


def test_constants_are_the_h100_datasheet():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 900e9)


@pytest.mark.parametrize("rec", RECORDS, ids=lambda r: r["arch"])
def test_analyze_record_matches_reference(reference_constants, rec):
    assert roofline.memory_bytes(rec) == jroof.memory_bytes(rec)
    if rec["status"] == "ok":
        assert (roofline.model_flops_per_device(rec)
                == jroof.model_flops_per_device(rec))
    assert roofline.analyze_record(rec) == jroof.analyze_record(rec)


def test_markdown_matches_reference(reference_constants):
    rows = [roofline.analyze_record(r) for r in RECORDS
            if r["status"] == "ok"]
    assert roofline.markdown(rows) == jroof.markdown(
        [jroof.analyze_record(r) for r in RECORDS if r["status"] == "ok"])


def test_chips_field_sets_the_device_count():
    rec = _record("granite-3-2b", "train_4k", "1", "train", chips=1)
    assert roofline.chips_of(rec) == 1
    assert (roofline.model_flops_per_device(rec)
            == 256 * roofline.model_flops_per_device(
                dict(rec, mesh="16x16", chips=None)))


def test_table_reads_the_dryrun_records(tmp_path, monkeypatch):
    path = tmp_path / "dryrun_torch.json"
    monkeypatch.setattr(roofline, "RESULTS", path)
    cfg = REDUCED_ARCHS["granite-3-2b"]
    rec = dryrun.run_cell(cfg, ShapeConfig("prefill_4k", 16, 2, "prefill"),
                          verbose=False)
    assert rec["status"] == "ok"
    # the roofline reads configs by name: a record of a published cell
    dryrun.save_result(dict(rec, arch="granite-3-2b", shape="prefill_32k"))
    dryrun.save_result(dict(rec, arch="granite-3-2b", shape="prefill_32k"))
    assert len(dryrun.load_results()) == 1
    rows = roofline.table()
    assert [r["shape"] for r in rows] == ["prefill_32k"]
    assert rows[0]["compute_s"] == rec["flops"] / 989e12
    assert "| granite-3-2b | prefill_32k |" in roofline.markdown(rows)
    assert json.loads(path.read_text())[0]["chips"] == 1


# --------------------------------------------------------------------------
# op_profile against hlo_profile
# --------------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_dot_flops_loop_free_matches_hlo_profile():
    @jax.jit
    def f(a, b):
        return jax.nn.relu(a @ b)

    compiled = f.lower(jax.ShapeDtypeStruct((64, 128), jnp.float32),
                       jax.ShapeDtypeStruct((128, 32), jnp.float32)).compile()
    want = hlo_profile.analyze(compiled.as_text())["dot_flops"]
    prof = op_profile.profile(lambda a, b: torch.relu(a @ b),
                              _meta(64, 128), _meta(128, 32))
    assert prof["dot_flops"] == want == 2 * 64 * 128 * 32
    assert prof["op_census"]["mm"] == 1
    assert prof["collectives"] == {} and prof["collective_operand_bytes"] == 0


def test_dot_flops_loop_matches_hlo_profile():
    @jax.jit
    def f(x, w):
        def body(c, _):
            return jax.nn.relu(c @ w), None
        out, _ = jax.lax.scan(body, x, None, length=5)
        return out

    compiled = f.lower(jax.ShapeDtypeStruct((32, 64), jnp.float32),
                       jax.ShapeDtypeStruct((64, 64), jnp.float32)).compile()
    want = hlo_profile.analyze(compiled.as_text())["dot_flops"]

    def g(x, w):
        for _ in range(5):
            x = torch.relu(x @ w)
        return x

    prof = op_profile.profile(g, _meta(32, 64), _meta(64, 64))
    assert prof["dot_flops"] == want == 5 * 2 * 32 * 64 * 64


def test_bytes_and_live_storages():
    """hbm_bytes sums each op's operands and results (views free); the
    peak counts storages made in the step while they live."""
    n = 1000 * 1000 * 4

    def f(a):
        b = a * 2                # reads a, writes b
        c = b.t()                # a view: no bytes, no storage
        d = c + 1                # reads b, writes d
        del b, c
        return d.sum()           # reads d, writes 4 bytes

    prof = op_profile.profile(f, _meta(1000, 1000))
    assert prof["hbm_bytes"] == 2 * n + 2 * n + n + 4
    assert prof["peak_bytes"] == 2 * n
    assert prof["memory"] == {"argument_size_bytes": n,
                              "output_size_bytes": 4,
                              "temp_size_bytes": 2 * n - 4}


def test_kernels_are_counted_not_run(monkeypatch):
    """While a profile is open each `kernels.ops` call records its own
    work and neither route runs; K3 counts the full Sq x Sk products."""
    def never(*a, **k):
        raise AssertionError("a kernel route ran under the count")

    for name in ("gnn_mp_ref", "lut_eval_ref", "flash_attention_ref",
                 "ssm_scan_ref"):
        monkeypatch.setattr(ref, name, never)
    B, H, KV, S, D = 2, 4, 2, 64, 16

    def step(q, k, v, adj, h, ws, wn, b, a, x, y0, lut, ia):
        o = ops.flash_attention(q, k, v, causal=True)
        g = ops.gnn_mp(adj, h, ws, wn, b)
        ys, yf = ops.ssm_scan(a, x, y0)
        return o, g, ys, yf, ops.lut_eval(lut, ia)

    args = (_meta(B, H, S, D), _meta(B, KV, S, D), _meta(B, KV, S, D),
            _meta(7, 7), _meta(256, 7, 12), _meta(12, 64), _meta(12, 64),
            _meta(64), _meta(S, 8), _meta(S, 32), _meta(32),
            torch.empty(256, dtype=torch.int32, device="meta"),
            torch.empty(100, dtype=torch.int32, device="meta"))
    prof = op_profile.profile(step, *args)
    o, g, ys, yf, lut = prof["result"]
    assert o.shape == (B, H, S, D) and g.shape == (256, 7, 64)
    assert ys.shape == (S, 32) and yf.shape == (32,)
    assert lut.shape == (100,) and lut.dtype == torch.int32
    assert prof["dot_flops"] == (4 * B * H * S * S * D
                                 + 2 * 256 * 7 * 12 * 64 * 2
                                 + 2 * 256 * 7 * 7 * 64)
    assert all(prof["op_census"][k] == 1 for k in
               ("flash_attention", "gnn_mp", "ssm_scan", "lut_eval"))
    assert ops.COUNTER is None


def test_kernel_gradients_are_counted():
    """Under autograd K3's backward counts twice its forward's products,
    and gradients reach the inputs."""
    B, H, S, D = 1, 2, 32, 16
    q, k, v = (torch.empty(B, H, S, D, device="meta", requires_grad=True)
               for _ in range(3))

    def step(q, k, v):
        ops.flash_attention(q, k, v, causal=True).sum().backward()
        return q.grad

    prof = op_profile.profile(step, q, k, v)
    assert prof["result"].shape == q.shape
    assert prof["dot_flops"] == 3 * 4 * B * H * S * S * D
    assert prof["op_census"]["flash_attention_backward"] == 1


# --------------------------------------------------------------------------
# dryrun: reduced steps against the analytic count and hlo_profile
# --------------------------------------------------------------------------

# one of each family; attn_chunk = S so the reference's attention is the
# full Sq x Sk product (smaller chunks skip causal blocks)
FAMILIES = ["granite-3-2b", "qwen2-vl-7b", "moonshot-v1-16b-a3b",
            "whisper-large-v3", "hymba-1.5b", "rwkv6-3b"]
S, B, ACCUM = 32, 4, 2
# the SSM and RWKV recurrences differentiate through products the two
# packages shape differently (an outer product is a product in torch and
# a broadcast multiply in XLA): their training counts agree within 1%
RECURRENT_TRAIN_RTOL = 1e-2


def _reference_dot_flops(cfg, shape):
    table = jtr.build_param_table(cfg)
    specs = jsteps.input_specs(cfg, shape)
    if shape.kind == "prefill":
        params = jax.tree.map(
            lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16),
            table.shapes())
        fn, args = jsteps.make_prefill_step(cfg), (params, specs)
    else:
        params = table.shapes()
        opt = jadamw.AdamWState(step=jax.ShapeDtypeStruct((), jnp.int32),
                                m=params, v=params)
        fn, args = jsteps.make_train_step(cfg, shape), (params, opt, specs)
    text = jax.jit(fn).lower(*args).compile().as_text()
    return hlo_profile.analyze(text)["dot_flops"]


def _head_flops(cfg, tokens):
    return 2 * cfg.d_model * cfg.vocab_size * tokens


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kind,remat", [("prefill", False),
                                        ("train", False), ("train", True)])
def test_dryrun_count_matches_hlo_profile(arch, kind, remat):
    """The port's prefill applies the head to the last position only (the
    reference to all S), and its chunked NLL recomputes each chunk's head
    product in the backward (XLA drops the recompute): with those terms
    moved, the counts are the reference's."""
    over = dict(attn_chunk=S, remat=remat)
    cfg = dataclasses.replace(REDUCED_ARCHS[arch], **over)
    jcfg = dataclasses.replace(J_ARCHS[arch], **over)
    accum = ACCUM if kind == "train" else 1
    rec = dryrun.run_cell(cfg, ShapeConfig(kind, S, B, kind,
                                           grad_accum=accum), verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    want = _reference_dot_flops(jcfg, JShape(kind, S, B, kind,
                                             grad_accum=accum))
    T = B * S
    if kind == "prefill":
        got = rec["flops"] + _head_flops(cfg, T - B)
    else:
        got = rec["flops"] - _head_flops(cfg, T)
    if kind == "train" and arch in ("hymba-1.5b", "rwkv6-3b"):
        assert got == pytest.approx(want, rel=RECURRENT_TRAIN_RTOL)
    else:
        assert got == want


def test_dryrun_count_matches_the_analytic_count():
    """Granite (dense, GQA), reduced: the prefill is 2 x the layers'
    parameters x tokens, plus the head at the last positions and the
    attention's full Sq x Sk products; training without remat is 3x that
    over all tokens, its head 4x (forward, recompute, two gradients);
    remat recomputes each block's forward up to its last product."""
    cfg = REDUCED_ARCHS["granite-3-2b"]
    d, L, f = cfg.d_model, cfg.n_layers, cfg.d_ff
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    # q, k, v, o and the gated MLP's three matrices
    layer_params = L * (d * (H + 2 * KV) * D + H * D * d + 3 * d * f)
    T = B * S
    attn = 4 * B * H * S * S * D * L
    prefill = dryrun.run_cell(cfg, ShapeConfig("p", S, B, "prefill"),
                              verbose=False)
    assert prefill["flops"] == (2 * layer_params * T + attn
                                + _head_flops(cfg, B))
    train = dryrun.run_cell(cfg, ShapeConfig("t", S, B, "train",
                                             grad_accum=ACCUM),
                            verbose=False)
    fwd = 2 * layer_params * T + attn
    assert train["flops"] == 3 * fwd + 4 * _head_flops(cfg, T)
    remat = dryrun.run_cell(dataclasses.replace(cfg, remat=True),
                            ShapeConfig("t", S, B, "train",
                                        grad_accum=ACCUM), verbose=False)
    last_product = 2 * T * f * d * L
    assert remat["flops"] == (4 * fwd - last_product
                              + 4 * _head_flops(cfg, T))
    # the record's fields
    assert train["memory"]["output_size_bytes"] >= \
        train["memory"]["argument_size_bytes"] - 2 * B * S * 4
    assert train["collective_bytes"] == 0 and train["chips"] == 1
    assert train["params"] == cfg.param_count()


def test_decode_cell_reads_the_cache():
    cfg = REDUCED_ARCHS["granite-3-2b"]
    rec = dryrun.run_cell(cfg, ShapeConfig("d", 64, 2, "decode"),
                          verbose=False)
    assert rec["status"] == "ok"
    cache = 2 * cfg.n_layers * 2 * 64 * cfg.n_kv_heads * \
        cfg.resolved_head_dim * 2 + 2 * 64 * 4
    params = 2 * sum(p.numel() for p in tree_leaves(
        dryrun.meta_params(cfg, torch.bfloat16)))
    assert rec["memory"]["argument_size_bytes"] == params + cache + 2 * 4


def test_unsupported_cell_is_skipped():
    rec = dryrun.run_cell("granite-3-2b", "long_500k", verbose=False)
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
