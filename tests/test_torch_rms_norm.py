"""The decoder blocks' RMSNorm: `layers.rms_norm` on the CPU and on meta
tensors runs the plain version exactly as before the kernel, the wrapper's
plan and checks, `_RmsNorm`'s backward math, and — on a CUDA card only —
the CUDA kernel against its plain version and its launches in a prefill."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import REDUCED_ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rms_norm as norm_kernel
from repro_torch.launch import dryrun, op_profile, steps
from repro_torch.launch.train import batch_on
from repro_torch.models import layers, transformer
from repro_torch.models.decoding import prefill
from repro_torch.optim import adamw

# the widths of the families' decoder blocks (Qwen2-VL-7B, Hymba-1.5B,
# Whisper large-v3, Granite-3-2B and Moonlight, RWKV-6 3B, Qwen2.5-32B,
# Granite-20B), then one with d % 8 != 0 and a short odd one
WIDTHS = (3584, 1600, 1280, 2048, 2560, 5120, 6144, 3588, 37)
# 2-byte types within one ulp: the kernel's float32 sum of squares is
# taken in another order, so a result may round to the neighbouring value
F32_RTOL, F64_RTOL = 1e-6, 1e-12


def _todays(x, gamma, eps):
    """The norm as `layers.rms_norm` computed it before the kernel."""
    dt = x.dtype
    x = layers.wide(x)
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * gamma.to(x.dtype)).to(dt)


def _inputs(shape, dtype, gamma_dtype=None, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device,
                    dtype=torch.float64).to(dtype)
    g = (1 + 0.1 * torch.randn(shape[-1], generator=gen, device=device,
                               dtype=torch.float64)).to(gamma_dtype or dtype)
    return x, g


# --------------------------------------------------------------------------
# on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,gamma_dtype", [
    (torch.bfloat16, None), (torch.float32, None), (torch.float64, None),
    (torch.bfloat16, torch.float32)])
def test_layers_rms_norm_on_the_cpu_is_the_formula_bit_for_bit(
        dtype, gamma_dtype):
    for shape in [(2, 5, 64), (3, 37), (7,)]:
        x, g = _inputs(shape, dtype, gamma_dtype)
        before = norm_kernel.LAUNCHES.value
        got = layers.rms_norm(x, g, 1e-6)
        assert got.dtype == dtype and got.shape == x.shape
        assert torch.equal(got, _todays(x, g, 1e-6))
        assert norm_kernel.LAUNCHES.value == before


def test_meta_tensors_take_the_plain_version():
    x = torch.empty(4, 9, 48, dtype=torch.bfloat16, device="meta")
    g = torch.empty(48, dtype=torch.bfloat16, device="meta")
    before = norm_kernel.LAUNCHES.value
    out = ops.rms_norm(x, g, 1e-5)
    assert out.device.type == "meta" and out.shape == x.shape
    assert out.dtype == torch.bfloat16
    assert norm_kernel.LAUNCHES.value == before


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_a_meta_count_of_a_small_model_is_unchanged(monkeypatch, kind):
    """`launch.op_profile` of a reduced Qwen2-VL step counts the same
    products, bytes, peak and ops as with the formula of before the
    kernel in place of `ops.rms_norm`."""
    cfg = REDUCED_ARCHS["qwen2-vl-7b"]
    shape = ShapeConfig(kind, 16, 2, kind)

    def count():
        step, args = dryrun.build_step(cfg, shape)
        prof = op_profile.profile(step, *args)
        return {k: prof[k] for k in ("dot_flops", "hbm_bytes", "peak_bytes",
                                     "op_census")}

    now = count()
    monkeypatch.setattr(ops, "rms_norm", _todays)
    assert now == count()


def test_the_wrapper_raises_on_what_it_cannot_launch():
    x, g = _inputs((3, 16), torch.bfloat16)
    with pytest.raises(ValueError, match="gamma"):
        norm_kernel.rms_norm(x, g[:15], 1e-6)
    with pytest.raises(ValueError, match="gamma"):
        norm_kernel.rms_norm(x, g[None], 1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        norm_kernel.rms_norm(x, g, 1e-6)
    with pytest.raises(ValueError, match="one of"):
        norm_kernel.rms_norm(x.to(torch.int32), g, 1e-6)


@pytest.mark.parametrize("d", WIDTHS + (8192,))
def test_the_plan_covers_a_row_in_whole_warps(d):
    for size in (2, 4, 8):
        for aligned in (d * size % 16 == 0, False):
            pl = norm_kernel.plan(d, size, aligned)
            assert pl.vec == (16 // size if aligned else 1)
            assert pl.per in norm_kernel.PER_THREAD
            assert pl.threads % 32 == 0 and 32 <= pl.threads <= 1024
            assert pl.threads * pl.per * pl.vec >= d
            # no whole warp idle; within 256 threads unless 8 loads a
            # thread are not enough
            assert (pl.threads - 32) * pl.per * pl.vec < d
            assert pl.threads <= norm_kernel.ROW_THREADS or pl.per == 8


def test_the_plan_of_the_cells_width():
    """Qwen2-VL-7B's rows in bf16: 448 16-byte vectors, 2 a thread over 7
    warps; a row off 16-byte boundaries goes element by element."""
    assert norm_kernel.plan(3584, 2, True) == norm_kernel.Plan(8, 2, 224)
    assert norm_kernel.plan(3584, 2, False) == norm_kernel.Plan(1, 8, 448)
    assert norm_kernel.plan(37, 2, False) == norm_kernel.Plan(1, 1, 64)
    with pytest.raises(ValueError, match="exceeds"):
        norm_kernel.plan(8 * 1024 + 1, 2, False)


def test_the_backward_is_the_plain_versions(monkeypatch):
    """`_RmsNorm` with its launch stood in by the plain version: the input
    gradients equal autograd's of the plain version bit for bit, and
    gamma's alone when x needs none."""
    monkeypatch.setattr(norm_kernel, "rms_norm", ref.rms_norm_ref)
    for dtype in (torch.bfloat16, torch.float32):
        x, g = _inputs((3, 5, 40), dtype, seed=1)
        up = _inputs((3, 5, 40), dtype, seed=2)[0]
        xa, ga = x.clone().requires_grad_(), g.clone().requires_grad_()
        xb, gb = x.clone().requires_grad_(), g.clone().requires_grad_()
        out = ops._RmsNorm.apply(xa, ga, 1e-6)
        out.backward(up)
        ref.rms_norm_ref(xb, gb, 1e-6).backward(up)
        assert torch.equal(out, ref.rms_norm_ref(x, g, 1e-6))
        assert torch.equal(xa.grad, xb.grad) and torch.equal(ga.grad, gb.grad)
        gc = g.clone().requires_grad_()
        ops._RmsNorm.apply(x, gc, 1e-6).backward(up)
        assert torch.equal(gc.grad, gb.grad)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _counted_launches(monkeypatch):
    """Route CPU tensors through `_RmsNorm` with its launch stood in by
    the plain version; the returned list grows by one a launch."""
    launched = []

    def launch(x, gamma, eps):
        launched.append(1)
        return ref.rms_norm_ref(x, gamma, eps)
    monkeypatch.setattr(norm_kernel, "rms_norm", launch)
    monkeypatch.setattr(ops, "rms_norm",
                        lambda x, g, eps: ops._RmsNorm.apply(x, g, eps))
    return launched


@pytest.mark.parametrize("name", ["qwen2-vl-7b", "hymba-1.5b",
                                  "whisper-large-v3", "rwkv6-3b",
                                  "moonshot-v1-16b-a3b"])
def test_the_smoke_runs_count_of_prefill_launches(monkeypatch, name):
    """`chip_smoke.norm_launches`, which the card's prefills are held to,
    is what a prefill launches: 2L + 1, Whisper's 3L + 1 + 2 enc + 1."""
    cs = _chip_smoke()
    launched = _counted_launches(monkeypatch)
    cfg = REDUCED_ARCHS[name]
    gen = torch.Generator().manual_seed(0)
    params = transformer.build_param_table(cfg).init(gen, device="cpu",
                                                     dtype=torch.bfloat16)
    S = cfg.n_vision_tokens + 4 if cfg.n_vision_tokens else 8
    tokens, extra = cs.family_inputs(cfg, gen, torch.device("cpu"), 2, S)
    with torch.inference_mode():
        steps.make_prefill_step(cfg, max_len=S)(
            params, cs.family_batch(tokens, extra, S))
    assert len(launched) == cs.norm_launches(cfg)


def test_the_smoke_runs_count_of_training_launches(monkeypatch):
    """A remat training step of two micro-batches launches the blocks'
    norms twice (forward and recompute) and the final norm once, per
    micro-batch; the backward launches none."""
    cs = _chip_smoke()
    launched = _counted_launches(monkeypatch)
    cfg = dataclasses.replace(REDUCED_ARCHS["hymba-1.5b"], remat=True)
    params = transformer.build_param_table(cfg).init(
        torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    step = steps.make_train_step(cfg, ShapeConfig("t", 16, 4, "train",
                                                  grad_accum=2))
    batch = batch_on(TokenPipeline(cfg.vocab_size, 16, 4).batch_at(0), {},
                     torch.device("cpu"))
    step(params, adamw.init(params), batch)
    assert len(launched) == 2 * cs.norm_launches(cfg, recompute=True) \
        == 2 * (4 * cfg.n_layers + 1)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_close(got, want):
    """2-byte types within one ulp of the plain version's result, per
    element; float32 within 1e-6 and float64 within 1e-12 relative."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.element_size() == 2:
        w = want.double()
        ulp = torch.finfo(want.dtype).eps * torch.exp2(
            torch.floor(torch.log2(w.abs().clamp_min(1e-30))))
        bad = (got.double() - w).abs() > ulp
        assert not bad.any(), (
            f"{int(bad.sum())} elements beyond one ulp, e.g. "
            f"{got[bad][:4].tolist()} for {want[bad][:4].tolist()}")
    else:
        rtol = F32_RTOL if want.dtype == torch.float32 else F64_RTOL
        torch.testing.assert_close(got, want, rtol=rtol, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32, torch.float64])
def test_cuda_rms_norm_matches_plain_version(dtype):
    dev = _card()
    for d in WIDTHS:
        for rows in (1, 7, 8192):
            x, g = _inputs((rows, d), dtype, device=dev, seed=d + rows)
            got = norm_kernel.rms_norm(x, g, 1e-6)
            want = ref.rms_norm_ref(x, g, 1e-6)
            torch.cuda.synchronize()
            _assert_close(got, want)


@pytest.mark.gpu
def test_cuda_rms_norm_takes_views_and_a_wider_gamma():
    """A (B, blk, d) slice of a (B, S, d) tensor (the mesh path's block),
    a view off 16-byte boundaries (element by element), rows with a
    stride beyond d, and a float32 gamma beside bf16 x."""
    dev = _card()
    x, g = _inputs((4, 96, 3584), torch.bfloat16, device=dev)
    cases = [(x[:, 32:64], g), (x.reshape(-1)[3:3 + 5 * 3584].view(5, 3584),
                               g), (x[:, 7, :1600], g[:1600]),
             (x, g.float())]
    for xv, gv in cases:
        got = norm_kernel.rms_norm(xv, gv, 1e-6)
        want = ref.rms_norm_ref(xv, gv, 1e-6)
        torch.cuda.synchronize()
        _assert_close(got, want)


@pytest.mark.gpu
def test_cuda_rms_norm_gradients_equal_the_plain_versions():
    dev = _card()
    for dtype in (torch.bfloat16, torch.float32):
        x, g = _inputs((2, 300, 3584), dtype, device=dev, seed=5)
        up = _inputs((2, 300, 3584), dtype, device=dev, seed=6)[0]
        xa, ga = x.clone().requires_grad_(), g.clone().requires_grad_()
        xb, gb = x.clone().requires_grad_(), g.clone().requires_grad_()
        ops.rms_norm(xa, ga, 1e-6).backward(up)
        ref.rms_norm_ref(xb, gb, 1e-6).backward(up)
        torch.cuda.synchronize()
        assert torch.equal(xa.grad, xb.grad) and torch.equal(ga.grad, gb.grad)


@pytest.mark.gpu
def test_cuda_prefill_launches_the_kernel_once_a_norm():
    """A Qwen2-VL-shaped prefill of 2 layers: 2L + 1 launches."""
    dev = _card()
    cfg = dataclasses.replace(REDUCED_ARCHS["qwen2-vl-7b"], n_layers=2)
    params = transformer.build_param_table(cfg).init(
        torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=torch.bfloat16)
    B, S = 2, 12
    batch = {"tokens": torch.arange(B * S, dtype=torch.int32, device=dev)
             .reshape(B, S) % cfg.vocab_size,
             "positions": torch.arange(S, dtype=torch.int32, device=dev)[
                 None, :, None].expand(B, S, 3).contiguous(),
             "vision_embeds": torch.full((B, cfg.n_vision_tokens,
                                          cfg.d_model), 0.01, device=dev)}
    norm_kernel.LAUNCHES.reset()
    with torch.inference_mode():
        prefill(cfg, params, batch)
    torch.cuda.synchronize()
    assert norm_kernel.LAUNCHES.value == 2 * cfg.n_layers + 1
