"""The LM slice's kernels: `flash_attention_ref` and `ssm_scan_ref` against
the JAX package's Pallas kernels (interpret mode) and pure-jnp oracles,
the per-device dispatch in `kernels.ops`, and — on a CUDA card only —
each CUDA kernel against its plain version.

The JAX side is imported inside the parity tests so that the card-only
tests collect on a host without JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as scan_kernel

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# (B, H, KV, S, D, bq, bk): test_kernels.py's sweep plus G = 5 (the
# slice's 25 heads over 5 KV heads: G not a power of two)
FA_SHAPES = [(1, 2, 1, 32, 8, 16, 16), (2, 4, 2, 64, 16, 32, 16),
             (1, 8, 2, 128, 32, 64, 64), (2, 2, 2, 64, 64, 64, 32),
             (1, 10, 2, 32, 16, 16, 16)]
# (T, D, block): test_kernels.py's sweep plus ragged T % block != 0
SCAN_SHAPES = [(64, 8, 16), (256, 32, 128), (128, 128, 32), (100, 16, 100),
               (200, 24, 128), (37, 8, 16)]


def _qkv(B, H, KV, S, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(dtype),
            rng.standard_normal((B, KV, S, D)).astype(dtype),
            rng.standard_normal((B, KV, S, D)).astype(dtype))


def _scan_inputs(T, D, seed, rep=1):
    rng = np.random.default_rng(seed)
    return ((rng.random((T, D // rep)) * 0.95).astype(np.float32),
            rng.standard_normal((T, D)).astype(np.float32),
            rng.standard_normal(D).astype(np.float32))


@pytest.mark.parametrize("B,H,KV,S,D,bq,bk", FA_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ref_matches_pallas(B, H, KV, S, D, bq, bk, causal):
    """float32, online softmax (Pallas) against a direct one (here):
    rtol/atol 1e-4, the bar of the reference's own kernel test; against
    the reference's direct jnp oracle 1e-5 (the same algorithm)."""
    import jax.numpy as jnp
    from repro.kernels import flash_attention as pallas_fa
    from repro.kernels import ref as jref
    arrs = _qkv(B, H, KV, S, D, seed=B * 100 + H * 10 + S)
    jq, jk, jv = map(jnp.asarray, arrs)
    got = ref.flash_attention_ref(*map(torch.from_numpy, arrs),
                                  causal=causal).numpy()
    pallas = np.asarray(pallas_fa.flash_attention(
        jq, jk, jv, bq=bq, bk=bk, causal=causal, interpret=True))
    oracle = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


def test_flash_attention_ref_bf16_matches_reference():
    """bf16 inputs, probabilities rounded to bf16 before PV in both: the
    jnp oracle within 2e-2 (one bf16 ulp of outputs of size ~1 is 2^-7,
    plus summation order); the Pallas kernel within test_kernels.py's
    0.05 (it rounds unnormalized probabilities)."""
    import jax.numpy as jnp
    from repro.kernels import flash_attention as pallas_fa
    from repro.kernels import ref as jref
    arrs = _qkv(1, 4, 2, 64, 16, seed=11)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    got = ref.flash_attention_ref(tq, tk, tv).float().numpy()
    assert ref.flash_attention_ref(tq, tk, tv).dtype == torch.bfloat16
    oracle = np.asarray(jref.flash_attention_ref(jq, jk, jv), np.float32)
    pallas = np.asarray(pallas_fa.flash_attention(
        jq, jk, jv, bq=32, bk=32, interpret=True), np.float32)
    np.testing.assert_allclose(got, oracle, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got, pallas, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("T,D,block", SCAN_SHAPES)
def test_ssm_scan_ref_matches_pallas(T, D, block):
    """The same float32 multiply-add sequence on both sides; XLA may fuse
    it into an FMA, so rtol 1e-5 / atol 1e-6 rather than bit-exact."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels import ssm_scan as pallas_scan
    a, b, y0 = _scan_inputs(T, D, seed=T + D)
    ys, yf = ref.ssm_scan_ref(*map(torch.from_numpy, (a, b, y0)))
    p_ys, p_yf = pallas_scan.ssm_scan(*map(jnp.asarray, (a, b, y0)),
                                      block=block, interpret=True)
    o_ys, o_yf = jref.ssm_scan_ref(*map(jnp.asarray, (a, b, y0)))
    for want_ys, want_yf in ((p_ys, p_yf), (o_ys, o_yf)):
        np.testing.assert_allclose(ys.numpy(), np.asarray(want_ys),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(yf.numpy(), np.asarray(want_yf),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(yf.numpy(), ys[-1].numpy())


@pytest.mark.parametrize("rep", [1, 4, 8])
def test_ops_ssm_scan_compact_decay_equals_expanded(rep):
    """A compact (T, D/R) decay is the expanded (T, D) one, bit for bit."""
    a, b, y0 = map(torch.from_numpy, _scan_inputs(33, 16, seed=rep, rep=rep))
    ys, yf = ops.ssm_scan(a, b, y0)
    want_ys, want_yf = ref.ssm_scan_ref(a.repeat_interleave(rep, 1), b, y0)
    assert torch.equal(ys, want_ys) and torch.equal(yf, want_yf)
    with pytest.raises(ValueError, match="D/R"):
        ops.ssm_scan(torch.zeros(33, 3), b, y0)     # 16 % 3 != 0


def test_lm_ops_on_cpu_run_the_plain_versions_and_launch_nothing():
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 2, 16, 8, seed=5))
    a, b, y0 = map(torch.from_numpy, _scan_inputs(9, 8, seed=5))
    n_fa, n_scan = fa_kernel.LAUNCHES.value, scan_kernel.LAUNCHES.value
    torch.testing.assert_close(ops.flash_attention(q, k, v, causal=False),
                               ref.flash_attention_ref(q, k, v,
                                                       causal=False),
                               rtol=0, atol=0)
    ys, yf = ops.ssm_scan(a, b, y0)
    assert torch.equal(ys, ref.ssm_scan_ref(a, b, y0)[0])
    assert (fa_kernel.LAUNCHES.value, scan_kernel.LAUNCHES.value) == \
        (n_fa, n_scan)


def test_lm_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch or raise: no silent plain-version fallback."""
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 1, 8, 16, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q, k, v)
    a, b, y0 = map(torch.from_numpy, _scan_inputs(4, 8, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        scan_kernel.ssm_scan(a, b, y0)


@pytest.mark.parametrize("D", fa_kernel.HEAD_DIMS)
def test_flash_attention_launch_plan_fits_the_card(D):
    """The bf16 kernel's plan for every head dim: its shared memory (two
    Q buffers, the K/V ring, the barriers, alignment slack) fits one
    block; both products are legal wgmma shapes (M = 64, N a multiple of
    8 up to 256, K = 16); a TMA box is at most one swizzle span wide (128
    bytes at most) and the boxes cover D."""
    plan = fa_kernel.plan(D)
    assert plan.head_dim == D
    assert plan.smem_bytes <= fa_kernel.SMEM_PER_BLOCK
    assert plan.smem_bytes >= (1024 + plan.q_buffers * plan.bq * D * 2
                               + 2 * plan.stages * plan.bk * D * 2
                               + 8 * (2 * plan.q_buffers + 3 * plan.stages))
    assert plan.q_buffers >= 1
    assert plan.stages >= 2
    for m_, n_, k_ in (plan.qk_wgmma, plan.pv_wgmma):
        assert (m_, k_) == (64, 16) and n_ % 8 == 0 and 8 <= n_ <= 256
    assert plan.qk_wgmma[1] == plan.bk and plan.pv_wgmma[1] == D
    assert plan.warpgroups in (2, 3)
    assert plan.bq == 64 * plan.warpgroups
    assert plan.threads == 128 * plan.warpgroups + 128
    assert plan.swizzle in fa_kernel.SWIZZLE_SPANS
    assert plan.box_cols * 2 == plan.swizzle <= 128
    assert plan.box_cols * plan.boxes == D and plan.box_cols % 16 == 0
    assert plan.launch_args() == (plan.bq, plan.bk, plan.stages,
                                  plan.threads, plan.smem_bytes)


def test_flash_attention_plan_refuses_other_head_dims():
    for D in (8, 48, 96, 256):
        with pytest.raises(ValueError, match="head dim"):
            fa_kernel.plan(D)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_flash_attention_matches_plain_version():
    """Model-layout (B,S,H,D) views, read in place. bf16: within 2e-2 of a
    plain version that rounds p at the same place (bf16 output ulp 2^-7
    at |o| ~ 1, plus exp2 and summation order); float32: within 1e-4."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, H, KV, S, D, dt, causal in [
            (2, 25, 5, 1024, 64, torch.bfloat16, True),
            (2, 25, 5, 1025, 64, torch.bfloat16, True),
            (2, 4, 2, 200, 128, torch.bfloat16, False),
            (2, 8, 1, 300, 128, torch.bfloat16, True),
            (1, 8, 2, 333, 32, torch.bfloat16, True),
            (1, 4, 2, 77, 16, torch.bfloat16, True),
            (2, 25, 5, 300, 64, torch.float32, True),
            (1, 4, 1, 33, 32, torch.float32, False)]:
        q = torch.randn(B, S, H, D, device=dev, generator=gen).to(dt)
        k = torch.randn(B, S, KV, D, device=dev, generator=gen).to(dt)
        v = torch.randn(B, S, KV, D, device=dev, generator=gen).to(dt)
        args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        got = fa_kernel.flash_attention(*args, causal=causal)
        want = ref.flash_attention_ref(*args, causal=causal)
        torch.cuda.synchronize()
        tol = 2e-2 if dt == torch.bfloat16 else 1e-4
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.gpu
def test_cuda_ssm_scan_matches_plain_version():
    """Rounded multiply then add on both sides: bit-exact, compact decay
    and ragged T included."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    for T, D, rep in [(1024, 2 * 25 * 64 * 16, 1024), (1000, 4096, 1),
                      (37, 1000, 8)]:
        a = torch.rand(T, D // rep, device=dev, generator=gen) * 0.95
        b = torch.randn(T, D, device=dev, generator=gen)
        y0 = torch.randn(D, device=dev, generator=gen)
        ys, yf = scan_kernel.ssm_scan(a, b, y0)
        want_ys, want_yf = ref.ssm_scan_ref(a.repeat_interleave(rep, 1), b,
                                            y0)
        torch.cuda.synchronize()
        assert torch.equal(ys, want_ys) and torch.equal(yf, want_yf)
