"""loss_fn and every parameter's gradient of the port
(`repro_torch.models.transformer.loss_fn`) against jax.value_and_grad of
the reference's loss_fn, for one reduced architecture of every family,
in float32 and bf16 compute on the CPU. The helpers and bars are
`test_torch_lm_train`'s."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as jtr
from repro_torch.models import transformer as ttr
from test_torch_lm_train import (BF16_GRAD, F32_GRAD, FAMILIES, _leaves,
                                 _pair, _port_loss_and_grads,
                                 _ref_loss_and_grads, _rel_l2, _train_batch)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_every_gradient_match_reference(name, dtype, monkeypatch):
    """loss_fn's total and NLL, and every parameter's gradient (float32
    master parameters, cast inside), against jax.value_and_grad of the
    reference's loss_fn. S = 24 with LOSS_CHUNK 8 runs three loss
    chunks.

    float32: F32_GRAD per-leaf relative L2 (the loss too).
    bf16: the loss within BF16_GRAD. A gradient leaf within BF16_GRAD of
    the reference's bf16 gradient, or, where the reference's own bf16
    gradient lies further than BF16_GRAD / 2 from its float32 gradient
    (the same parameters and batch in float32 compute), within twice
    that distance: at d_model 64 a bf16 backward's rounding moves some
    leaves by 3-30% (Hymba's SSM decay, RWKV's mixes, the MoE products,
    Whisper's cross-attention; the reference's bf16 against its float32
    reads up to 0.32), and the two packages round at different places,
    so their bf16 gradients are two draws of that error. The port's bf16
    gradient is also held to the float32 gradient by the same measure:
    no further from it than twice the reference's bf16 gradient is."""
    jcfg, tcfg, jp, tp = _pair(name, dtype)
    batch = _train_batch(jcfg, 2, 24, seed=2)
    monkeypatch.setattr(jtr, "LOSS_CHUNK", 8)
    monkeypatch.setattr(ttr, "LOSS_CHUNK", 8)
    jt, jl, jg = _ref_loss_and_grads(jcfg, jp, batch)
    tt, tl, tg = _port_loss_and_grads(tcfg, tp, batch)
    f32 = dtype == "float32"
    np.testing.assert_allclose([tt, tl], [jt, jl],
                               rtol=F32_GRAD if f32 else BF16_GRAD)
    assert (tt > tl) == tcfg.is_moe          # the load-balancing term
    jleaves = jax.tree.leaves(jg)
    tleaves = _leaves(tg)
    assert len(tleaves) == len(jleaves)
    if not f32:
        exact = jax.tree.leaves(_ref_loss_and_grads(
            dataclasses.replace(jcfg, dtype="float32"), jp, batch)[2])
    for i, (a, b) in enumerate(zip(tleaves, jleaves)):
        assert a is not None and a.dtype == torch.float32
        assert tuple(a.shape) == b.shape
        got = _rel_l2(a.numpy(), b)
        if f32:
            assert got <= F32_GRAD, (i, got)
            continue
        ref_err = _rel_l2(b, exact[i])
        bar = max(BF16_GRAD, 2 * ref_err)
        assert got <= bar, (i, got, ref_err)
        assert _rel_l2(a.numpy(), exact[i]) <= bar, (i, ref_err)
