"""The LM training slice of the port (`repro_torch.models.transformer.
loss_fn`, remat, `launch.steps.make_train_step`, `optim.adamw`,
`distributed.compression`, `data.tokens`, `launch.train`) against the JAX
package at reduced sizes on the CPU, and the gradients of the two LM
kernels (`kernels.ops`): their reverse-time and recompute backward
against autograd of the plain versions.

Weights come from the reference's `ParamTable.init` (float32 master
parameters) and are carried over with `params_from_numpy`; batches are
made with numpy from a seed. The reference's step runs under plain
``jax.jit`` without a mesh (its `launch.train` cannot run a step on this
tree: ROADMAP queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED_ARCHS as J_ARCHS
from repro.configs.base import ShapeConfig as JShape
from repro.data.tokens import TokenPipeline as JPipe
from repro.distributed import compression as jcomp
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro_torch.configs import REDUCED_ARCHS as T_ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed.fault import FaultInjector
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import (params_from_numpy, tree_leaves,
                                       tree_map)
from repro_torch.optim import adamw
from test_torch_families import family_batch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# one architecture of every family: dense, hybrid, both MoE layouts, the
# VLM, RWKV-6 and Whisper's encoder-decoder
FAMILIES = ["granite-3-2b", "hymba-1.5b", "mixtral-8x7b",
            "moonshot-v1-16b-a3b", "qwen2-vl-7b", "rwkv6-3b",
            "whisper-large-v3"]
# float32 compute: the same algorithm in another summation order; a
# leaf's gradient within 1e-4 relative L2
F32_GRAD = 1e-4
# bf16 compute: both packages round activations and products to bf16, at
# places that differ (XLA fuses, PyTorch rounds every op's output); a
# one-ulp (2^-8) difference in an activation moves a gradient leaf by a
# few 1e-3 relative: 2e-2
BF16_GRAD = 2e-2
# AdamW, the schedule and clipping: float32 elementwise work, 1e-6
ADAM_RTOL = 1e-6


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _leaves(tree):
    """Leaves in jax.tree order (dict keys sorted, lists in order)."""
    return tree_leaves(tree)


def _rel_l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _pair(name, dtype="float32", seed=1, **over):
    jcfg = dataclasses.replace(J_ARCHS[name], dtype=dtype, **over)
    tcfg = dataclasses.replace(T_ARCHS[name], dtype=dtype, **over)
    jp = jtr.build_param_table(jcfg).init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _train_batch(cfg, B, S, seed, ragged=True):
    """A training batch: tokens, the family's stub-frontend inputs, and
    next-token labels with -1 at the end of each row; ``ragged`` also
    masks a different number of leading labels in each row, so the rows'
    label counts differ."""
    batch = family_batch(cfg, B, S, seed)
    toks = batch["tokens"]
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)],
                            1)
    if ragged:
        for r in range(B):
            labels[r, :(0, 11, 3, 13)[r % 4] % (S - 2)] = -1
    batch["labels"] = labels.astype(np.int32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch, cfg):
    out = {k: _t(v) for k, v in batch.items()}
    for k in ("vision_embeds", "enc_frames"):
        if k in out and cfg.dtype == "bfloat16":
            out[k] = out[k].to(torch.bfloat16)
    return out


def _ref_loss_and_grads(jcfg, jp, batch):
    (total, m), g = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.loss_fn(jcfg, p, b), has_aux=True))(
            jp, _jax_batch(batch))
    return float(total), float(m["loss"]), g


def _port_loss_and_grads(tcfg, tp, batch):
    tp = tree_map(lambda a: a.clone().requires_grad_(True), tp)
    total, m = ttr.loss_fn(tcfg, tp, _torch_batch(batch, tcfg))
    total.backward()
    return (float(total.detach()), float(m["loss"].detach()),
            tree_map(lambda a: a.grad, tp))


# --------------------------------------------------------------------------
# data, optimizer, compression
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,step", [("granite-3-2b", 0), ("granite-3-2b", 7),
                                       ("qwen2-vl-7b", 3),
                                       ("whisper-large-v3", 5)])
def test_token_pipeline_matches_reference(name, step):
    """Tokens and labels bit for bit; the family's extras from the same
    generator in the same order: integers equal, bf16 draws equal to the
    reference's ml_dtypes rounding."""
    cfg = J_ARCHS[name]
    shape = JShape("t", 24, 4, "train")
    jspecs = {k: v for k, v in jsteps.input_specs(cfg, shape).items()
              if k not in ("tokens", "labels")}
    tspecs = {k: v for k, v in tsteps.input_specs(
        T_ARCHS[name], ShapeConfig("t", 24, 4, "train")).items()
        if k not in ("tokens", "labels")}
    assert {k: (tuple(s.shape), str(s.dtype)) for k, s in jspecs.items()} \
        == {k: (s, str(d).replace("torch.", ""))
            for k, (s, d) in tspecs.items()}
    want = JPipe(cfg.vocab_size, 24, 4, seed=3).batch_at(step, jspecs)
    got = TokenPipeline(cfg.vocab_size, 24, 4, seed=3).batch_at(step, tspecs)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], np.asarray(want[k],
                                                         got[k].dtype))
        if k in ("tokens", "labels", "positions"):
            assert got[k].dtype == want[k].dtype


def test_adamw_matches_reference():
    """Three AdamW updates (clipping active on the first), the cosine
    schedule through warmup and decay, and clip_by_global_norm, against
    the reference at ADAM_RTOL."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(_t, params)
    jst, tst = jadamw.init(jp), adamw.init(tp)
    jlr = jadamw.cosine_schedule(1e-2, 2, 6)
    tlr = adamw.cosine_schedule(1e-2, 2, 6)
    for s in range(8):
        np.testing.assert_allclose(
            float(tlr(torch.tensor(s, dtype=torch.int32))),
            float(jlr(jnp.int32(s))), rtol=ADAM_RTOL)
    for i in range(3):
        g = {"a": (rng.standard_normal((5, 7)) * (5 if i == 0 else 0.1))
             .astype(np.float32),
             "b": {"c": rng.standard_normal(11).astype(np.float32)}}
        jc, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                            1.0)
        tc, tn = adamw.clip_by_global_norm(tree_map(_t, g), 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=ADAM_RTOL)
        for a, b in zip(_leaves(tc), jax.tree.leaves(jc)):
            np.testing.assert_allclose(a.numpy(), _np(b), rtol=ADAM_RTOL)
        jp, jst, jm = jadamw.update(jax.tree.map(jnp.asarray, g), jst, jp,
                                    jlr)
        tp, tst, tm = adamw.update(tree_map(_t, g), tst, tp, tlr)
        assert int(tst.step) == int(jst.step) == i + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=ADAM_RTOL)
        for a, b in zip(_leaves((tp, tst.m, tst.v)),
                        jax.tree.leaves((jp, jst.m, jst.v))):
            np.testing.assert_allclose(a.numpy(), _np(b), rtol=ADAM_RTOL,
                                       atol=1e-9)


def test_quantize_and_compress_tree_match_reference():
    """int8 values bit for bit; scales, dequantized values and residuals
    equal as float32 (the same float32 operations)."""
    rng = np.random.default_rng(1)
    g = {"w": (rng.standard_normal((6, 9)) * 3).astype(np.float32),
         "z": [rng.standard_normal(13).astype(np.float32),
               np.zeros(4, np.float32)]}
    res = tree_map(lambda a: (a * 1e-2).astype(np.float32), g)
    q, s = tcomp.quantize(_t(g["w"]))
    jq, js = jcomp.quantize(jnp.asarray(g["w"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8 and float(s) == float(js)
    for r in (None, res):
        tc, tr = tcomp.compress_tree(
            tree_map(_t, g), None if r is None else tree_map(_t, r))
        jc, jr = jcomp.compress_tree(
            jax.tree.map(jnp.asarray, g),
            None if r is None else jax.tree.map(jnp.asarray, r))
        for a, b in zip(_leaves(tc), jax.tree.leaves(jc)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(_leaves(tr), jax.tree.leaves(jr)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(_leaves(tcomp.decompress_tree(tc)),
                        jax.tree.leaves(jcomp.decompress_tree(jc))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    avg, new_res = tcomp.ef_allreduce(tree_map(_t, g), tree_map(_t, res))
    javg, jres = jcomp.ef_allreduce(jax.tree.map(jnp.asarray, g),
                                    jax.tree.map(jnp.asarray, res))
    for a, b in zip(_leaves((avg, new_res)), jax.tree.leaves((javg, jres))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # over a named axis the leaves are placed on a mesh
    # (test_torch_lm_mesh.py holds that against shard_map)
    with pytest.raises(TypeError, match="placed"):
        tcomp.ef_allreduce(tree_map(_t, g), None, axis_name="pod")


# --------------------------------------------------------------------------
# the loss and its gradients
# --------------------------------------------------------------------------

def test_remat_on_and_off_give_equal_gradients():
    """Reduced Hymba and Whisper (the encoder's checkpoints too) in
    float32: the checkpointed blocks recompute the same operations, so
    the loss and every gradient are equal bit for bit."""
    for name in ("hymba-1.5b", "whisper-large-v3", "rwkv6-3b"):
        _, tcfg, _, tp = _pair(name)
        batch = _train_batch(tcfg, 2, 16, seed=3)
        off = _port_loss_and_grads(tcfg, tp, batch)
        on = _port_loss_and_grads(dataclasses.replace(tcfg, remat=True),
                                  tp, batch)
        assert on[:2] == off[:2]
        for a, b in zip(_leaves(on[2]), _leaves(off[2])):
            assert torch.equal(a, b)


def test_forward_hidden_is_the_normed_stream_before_the_head():
    _, tcfg, _, tp = _pair("granite-3-2b")
    batch = _torch_batch(_train_batch(tcfg, 2, 8, seed=4), tcfg)
    hidden, aux, (kvs, enc) = ttr.forward(tcfg, tp, batch, kind="hidden")
    logits, _, _ = ttr.forward(tcfg, tp, batch)
    assert kvs is None and enc is None and hidden.shape == (2, 8, 64)
    torch.testing.assert_close(hidden @ ttr.head_weight(tcfg, tp), logits)


# --------------------------------------------------------------------------
# the train step and the loop
# --------------------------------------------------------------------------

def _ref_step(jcfg, shape, jp, batch, steps=1, **kw):
    fn = jax.jit(jsteps.make_train_step(jcfg, shape, **kw))
    state = jadamw.init(jp)
    out = []
    for i in range(steps):
        b = batch(i) if callable(batch) else batch
        jp, state, m = fn(jp, state, _jax_batch(b))
        out.append({k: float(v) for k, v in m.items()})
    return jp, state, out


def _port_step(tcfg, shape, tp, batch, steps=1, **kw):
    """The port's steps on a copy of ``tp`` (a step writes in place)."""
    fn = tsteps.make_train_step(tcfg, shape, **kw)
    tp = tree_map(torch.clone, tp)
    state = adamw.init(tp)
    out = []
    for i in range(steps):
        b = batch(i) if callable(batch) else batch
        tp, state, m = fn(tp, state, _torch_batch(b, tcfg))
        out.append({k: float(v) for k, v in m.items()})
    return tp, state, out


@pytest.mark.parametrize("name", ["hymba-1.5b", "moonshot-v1-16b-a3b"])
def test_grad_accum_step_matches_reference(name):
    """One step with grad_accum = 2 on a batch of 4 rows whose label
    counts differ: micro-batch j holds rows j and j + 2 (the reference's
    reshape-and-swap split), each averages its own labels; the loss,
    grad norm, lr and every parameter and moment after the step against
    the reference's jitted step (float32 compute, F32_GRAD). A contiguous
    split changes the loss beyond the bar, and so does one that averages
    over the whole batch's labels."""
    jcfg, tcfg, jp, tp = _pair(name)
    shape = ShapeConfig("t", 16, 4, "train", grad_accum=2)
    batch = _train_batch(tcfg, 4, 16, seed=5)
    kw = dict(base_lr=1e-2, warmup=0, total_steps=10)
    jp2, jst, jm = _ref_step(jcfg, JShape("t", 16, 4, "train",
                                           grad_accum=2), jp, batch, **kw)
    tp2, tst, tm = _port_step(tcfg, shape, tp, batch, **kw)
    for k in ("loss", "grad_norm", "lr", "moe_aux"):
        np.testing.assert_allclose(tm[0][k], jm[0][k], rtol=F32_GRAD,
                                   atol=1e-7)
    for a, b in zip(_leaves((tp2, tst.m, tst.v)),
                    jax.tree.leaves((jp2, jst.m, jst.v))):
        assert _rel_l2(a.numpy(), b) <= F32_GRAD
    # the wrong splits: contiguous halves, or one average over all rows
    def mean_loss(rows_list):
        losses = [ttr.loss_fn(tcfg, tp, _torch_batch(
            {k: v[rows] for k, v in batch.items()}, tcfg))[1]["loss"]
            for rows in rows_list]
        return float(sum(losses) / len(losses))
    right = mean_loss([[0, 2], [1, 3]])
    np.testing.assert_allclose(right, jm[0]["loss"], rtol=F32_GRAD)
    for wrong in (mean_loss([[0, 1], [2, 3]]), mean_loss([[0, 1, 2, 3]])):
        assert abs(wrong - right) > 10 * F32_GRAD * abs(right)


def test_ten_step_loss_trajectory_matches_reference():
    """Reduced granite in float32, ten steps on TokenPipeline batches
    (the same tokens in both packages): every step's loss and grad norm
    within 1e-4 relative, and the parameters after ten steps within
    1e-3 per-leaf relative L2 (float32 differences in the gradients,
    carried through ten Adam steps)."""
    jcfg, tcfg, jp, tp = _pair("granite-3-2b")
    shape = ShapeConfig("t", 16, 4, "train")
    pipe = TokenPipeline(tcfg.vocab_size, 16, 4)
    kw = dict(base_lr=3e-3, warmup=3, total_steps=10)
    jp2, _, jm = _ref_step(jcfg, JShape("t", 16, 4, "train"), jp,
                           pipe.batch_at, steps=10, **kw)
    tp2, _, tm = _port_step(tcfg, shape, tp, pipe.batch_at, steps=10, **kw)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose([a["loss"], a["grad_norm"], a["lr"]],
                                   [b["loss"], b["grad_norm"], b["lr"]],
                                   rtol=1e-4)
    for a, b in zip(_leaves(tp2), jax.tree.leaves(jp2)):
        assert _rel_l2(a.numpy(), b) <= 1e-3


def _same_state(a, b):
    for x, y in zip(_leaves((a["params"], a["opt"])),
                    _leaves((b["params"], b["opt"]))):
        assert torch.equal(x, y)


def test_train_restarts_after_a_crash_and_ends_bit_equal(tmp_path):
    """Reduced Hymba on the CPU: a host failure at step 6 with
    checkpoints every 2 steps restores step 5 and reaches step 10; the
    parameters and the AdamW state equal an uninterrupted run's bit for
    bit (stateless batches, a deterministic CPU step), and the last
    checkpoint holds them."""
    from repro_torch import checkpointing as ck
    cfg = T_ARCHS["hymba-1.5b"]
    shape = ShapeConfig("t", 16, 2, "train")
    kw = dict(ckpt_every=2, log_every=0, device="cpu")
    out = ttrain.train(cfg, shape, 10, str(tmp_path / "a"),
                       injector=FaultInjector(crash_at=[6]), **kw)
    assert out["final_step"] == 10 and \
        out["mesh"] == (("data", 1), ("model", 1))
    assert len(out["losses"]) == 4            # steps 6-9 after the restart
    ref_run = ttrain.train(cfg, shape, 10, str(tmp_path / "b"), **kw)
    _same_state(out, ref_run)
    assert ck.latest_step(tmp_path / "a") == 9
    saved, step = ck.restore(tmp_path / "a", (out["params"], out["opt"]))
    assert step == 9
    for x, y in zip(_leaves(saved), _leaves((out["params"], out["opt"]))):
        assert torch.equal(x, y)
    assert ref_run["losses"][6:] == out["losses"]


def test_train_from_reference_params_and_without_a_card():
    """build_state takes the reference's parameters (float32), and the
    entry points raise without a card unless device="cpu"."""
    jcfg, tcfg, jp, _ = _pair("granite-3-2b", dtype="bfloat16")
    jnp_params = jax.tree.map(np.asarray, jp)
    params, opt = ttrain.build_state(tcfg, "cpu", init_params=jnp_params)
    for a, b in zip(_leaves(params), jax.tree.leaves(jnp_params)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), _np(b))
    assert int(opt.step) == 0 and all(
        float(m.abs().sum()) == 0 for m in _leaves(opt.m))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrain.build_state(tcfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrain.train(tcfg, ShapeConfig("t", 8, 2, "train"), 1, None)


def test_train_cli_on_the_cpu(capsys, tmp_path):
    ttrain.main(["--arch", "hymba-1.5b", "--reduced", "--steps", "4",
                 "--batch", "2", "--seq", "16", "--accum", "2",
                 "--ckpt", str(tmp_path), "--ckpt-every", "2",
                 "--crash-at", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[failure] injected host failure at step 3" in out
    assert "[restore] resumed from step 1" in out
    assert "done: 4 steps" in out


# --------------------------------------------------------------------------
# the kernels' gradients
# --------------------------------------------------------------------------

def _plain_kernels(monkeypatch):
    """Stand the CUDA launches of the two autograd Functions in with the
    plain versions, so their backward math runs here; the Functions are
    applied directly (the dispatch sends CPU tensors to the plain
    version)."""
    monkeypatch.setattr(ops._scan, "ssm_scan", lambda a, b, y0: ref.
                        ssm_scan_ref(a.repeat_interleave(
                            b.shape[1] // a.shape[1], 1), b, y0))
    monkeypatch.setattr(ops._fa, "flash_attention", ref.flash_attention_ref)


@pytest.mark.parametrize("rep", [1, 4])
def test_ssm_scan_backward_is_the_reverse_scan(monkeypatch, rep):
    """_SsmScan's backward (one scan over reversed time, then the decay's
    and the start's gradients, summed over a compact column's R
    channels) against autograd of the plain loop, float64: 1e-12."""
    _plain_kernels(monkeypatch)
    rng = np.random.default_rng(rep)
    T, D = 19, 8
    a0 = torch.from_numpy(rng.random((T, D // rep)) * 0.9 + 0.05)
    b0 = torch.from_numpy(rng.standard_normal((T, D)))
    y00 = torch.from_numpy(rng.standard_normal(D))
    gy = torch.from_numpy(rng.standard_normal((T, D)))
    gf = torch.from_numpy(rng.standard_normal(D))
    res = []
    for fn in (ops._SsmScan.apply, lambda a, b, y0: ref.ssm_scan_ref(
            a.repeat_interleave(rep, 1), b, y0)):
        a, b, y0 = (x.clone().requires_grad_(True) for x in (a0, b0, y00))
        ys, yf = fn(a, b, y0)
        res.append(torch.autograd.grad((ys * gy).sum() + (yf * gf).sum(),
                                       (a, b, y0)))
    for g, w in zip(*res):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_backward_is_the_plain_versions(monkeypatch,
                                                        causal):
    """_FlashAttention's backward returns the plain version's input
    gradients for the same call (grouped heads, G = 2), float32."""
    _plain_kernels(monkeypatch)
    rng = np.random.default_rng(7)
    q0 = torch.from_numpy(rng.standard_normal((2, 4, 12, 8))).float()
    k0 = torch.from_numpy(rng.standard_normal((2, 2, 12, 8))).float()
    v0 = torch.from_numpy(rng.standard_normal((2, 2, 12, 8))).float()
    g = torch.from_numpy(rng.standard_normal((2, 4, 12, 8))).float()
    res = []
    for fn in (lambda q, k, v: ops._FlashAttention.apply(q, k, v, causal),
               lambda q, k, v: ref.flash_attention_ref(q, k, v,
                                                       causal=causal)):
        q, k, v = (x.clone().requires_grad_(True) for x in (q0, k0, v0))
        res.append(torch.autograd.grad(fn(q, k, v), (q, k, v), g))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # only the inputs that need a gradient get one
    q = q0.clone().requires_grad_(True)
    (gq,) = torch.autograd.grad(ops._FlashAttention.apply(q, k0, v0, causal),
                                (q,), g)
    torch.testing.assert_close(gq, res[1][0], rtol=0, atol=0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_ssm_scan_gradients_match_plain_version():
    """On the card, at Hymba's layout (compact decay, R = Dh*N): K4
    forward, K4 over reversed time backward, against autograd of the
    plain loop on the card; float32, relative L2 1e-5 per input."""
    from repro_torch.kernels import ssm_scan as k4
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    T, heads, rep = 256, 8, 64
    a0 = torch.rand(T, heads, generator=gen, device=dev) * 0.9 + 0.05
    b0 = torch.randn(T, heads * rep, generator=gen, device=dev)
    y00 = torch.randn(heads * rep, generator=gen, device=dev)
    gy = torch.randn(T, heads * rep, generator=gen, device=dev)
    res = []
    for kernel in (True, False):
        a, b, y0 = (x.clone().requires_grad_(True) for x in (a0, b0, y00))
        n = k4.LAUNCHES.value
        ys, yf = (ops.ssm_scan(a, b, y0) if kernel else ref.ssm_scan_ref(
            a.repeat_interleave(rep, 1), b, y0))
        res.append(torch.autograd.grad((ys * gy).sum() + yf.sum(),
                                       (a, b, y0)))
        assert k4.LAUNCHES.value - n == (2 if kernel else 0)
    for g, w in zip(*res):
        assert float((g - w).norm() / w.norm()) <= 1e-5


@pytest.mark.gpu
def test_cuda_flash_attention_gradients_match_plain_version():
    """On the card, bf16 at Hymba's heads (25 over 5, D = 64): K3 forward
    and the plain backward against autograd of the plain version; the
    same function of the same inputs, so within 1e-2 relative L2 of
    each input's gradient (bf16 rounding of the gradients)."""
    from repro_torch.kernels import flash_attention as k3
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = ((1, 25, 5, 256, 64), (1, 5, 5, 256, 64))
    res = []
    for kernel in (True, False):
        for B, H, KV, S, D in shapes:
            torch.manual_seed(0)
            q = torch.randn(B, H, S, D, device=dev).bfloat16()
            k = torch.randn(B, KV, S, D, device=dev).bfloat16()
            v = torch.randn(B, KV, S, D, device=dev).bfloat16()
            g = torch.randn(B, H, S, D, device=dev).bfloat16()
            q, k, v = (x.requires_grad_(True) for x in (q, k, v))
            n = k3.LAUNCHES.value
            o = (ops.flash_attention(q, k, v) if kernel
                 else ref.flash_attention_ref(q, k, v))
            res.append(torch.autograd.grad(o, (q, k, v), g))
            assert k3.LAUNCHES.value - n == (1 if kernel else 0)
    half = len(shapes)
    for got, want in zip(res[:half], res[half:]):
        for a, b in zip(got, want):
            a, b = a.float(), b.float()
            assert float((a - b).norm() / b.norm()) <= 1e-2
