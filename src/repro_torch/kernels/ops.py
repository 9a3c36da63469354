"""Per-device dispatch of the kernels.

A tensor on the CPU goes to the kernel's plain PyTorch version
(`kernels.ref`), which autograd differentiates as it is; a CUDA tensor
goes to the hand-written kernel, whose wrapper raises on anything it
cannot launch. There is no fallback from the kernel to the plain version:
which one ran follows from the device.

The LM kernels carry gradients on the card through
`torch.autograd.Function`s (the JAX package differentiates plain jnp
code and has no backward kernel):
- `ssm_scan`'s backward is the same CUDA kernel run over reversed time
  (`_SsmScan`);
- `flash_attention`'s and `rms_norm`'s backward recompute the plain
  version for that call and return its input gradients
  (`_FlashAttention`, `_RmsNorm`); their forward is the kernel.
Each forward and backward of K3 and K4 runs under a span (`SPANS`,
`repro_torch.spans`), which a profiler reads to split a step's device
time; `rms_norm` runs under its caller's (`models.layers.rms_norm`).

While `launch.op_profile` counts a step on meta tensors, `COUNTER` is
set and every call goes to it instead: it records the kernel's work and
returns outputs of the right shapes, so neither route runs. On the card
that costs each call one check of `COUNTER`. `rms_norm` is the exception:
a meta tensor takes its plain version, whose operations the count sees
as it always has.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gnn_mp as _mp
from repro_torch.kernels import lut_eval as _lut
from repro_torch.kernels import ref
from repro_torch.kernels import rms_norm as _norm
from repro_torch.kernels import ssm_scan as _scan
from repro_torch.spans import span

SPANS = ("flash_attention_forward", "flash_attention_backward",
         "ssm_scan_forward", "ssm_scan_backward")

# the open `launch.op_profile` count, if any
COUNTER = None


def gnn_mp(adj, h, w_self, w_nbr, b):
    """relu(A @ (H @ Wn) + H @ Ws + b); adj (N,N) shared or (B,N,N)."""
    if COUNTER is not None:
        return COUNTER.kernel("gnn_mp", adj, h, w_self, w_nbr, b)
    if h.device.type == "cpu":
        return ref.gnn_mp_ref(adj, h, w_self, w_nbr, b)
    return _mp.gnn_mp(adj, h, w_self, w_nbr, b)


def lut_eval(lut, a, b=None, wb: int = 0):
    """int32 gather ``lut[(a << wb) | b]`` over 1-D a, b; ``lut[a]``
    when b is None (wb must be 0)."""
    if COUNTER is not None:
        return COUNTER.kernel("lut_eval", lut, a, b, wb)
    if a.device.type == "cpu":
        return ref.lut_eval_ref(lut, a, b, wb)
    return _lut.lut_eval(lut, a, b, wb)


class _FlashAttention(torch.autograd.Function):
    """K3 forward; backward through the plain version of the same call
    (float32 scores of one call, about 420 MB at Hymba's micro-batch of 4
    and S = 1024, live only inside this backward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _fa.flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((q, k, v), ctx.needs_input_grad[:3])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad(), span("flash_attention_backward"):
            out = ref.flash_attention_ref(*inputs, causal=ctx.causal)
            got = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(got) if t.requires_grad else None
                     for t in inputs) + (None,)


def flash_attention(q, k, v, *, causal: bool = True):
    """Attention with grouped KV heads; q (B,H,Sq,D), k/v (B,KV,Sk,D),
    Sq <= Sk, the causal mask aligned bottom-right (query row i at key
    position Sk - Sq + i)."""
    if COUNTER is not None:
        return COUNTER.kernel("flash_attention", q, k, v, causal)
    with span("flash_attention_forward"):
        if q.device.type == "cpu":
            return ref.flash_attention_ref(q, k, v, causal=causal)
        return _FlashAttention.apply(q, k, v, causal)


class _RmsNorm(torch.autograd.Function):
    """The norm's kernel forward; backward through the plain version of
    the same call (its float32 copy of x lives only inside this
    backward)."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, gamma)
        return _norm.rms_norm(x, gamma, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((x, gamma), ctx.needs_input_grad[:2])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = ref.rms_norm_ref(*inputs, ctx.eps)
            got = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(got) if t.requires_grad else None
                     for t in inputs) + (None,)


def rms_norm(x, gamma, eps: float):
    """x * rsqrt(mean(x^2) + eps) * gamma over the last dimension, in
    float32 (float64 for float64 x), rounded once to x's type. CPU and
    meta tensors take the plain version."""
    if x.device.type in ("cpu", "meta"):
        return ref.rms_norm_ref(x, gamma, eps)
    return _RmsNorm.apply(x, gamma, eps)


class _SsmScan(torch.autograd.Function):
    """K4 forward, saving ys; backward is K4 again over reversed time.

    With g_t the gradient of y_t (plus that of y_final at t = T-1), the
    adjoint c_t = dL/dy_t in full obeys c_t = g_t + a_{t+1} c_{t+1}: in
    reversed time s = T-1-t that is the forward scan
    c'_s = a_{T-s} c'_{s-1} + g_{T-1-s} from c'_{-1} = 0, one launch on
    flipped inputs whose decay row 0 multiplies the zero start. The
    compact (T, D/R) decay keeps its layout. Then dL/db = c,
    dL/da_t = c_t y_{t-1} (y_{-1} = y0; summed over the R channels of a
    compact column) and dL/dy0 = a_0 c_0."""

    @staticmethod
    def forward(ctx, a, b, y0):
        ys, yf = _scan.ssm_scan(a, b, y0)
        ctx.save_for_backward(a, ys, y0)
        return ys, yf

    @staticmethod
    def backward(ctx, g_ys, g_yf):
        with span("ssm_scan_backward"):
            return _SsmScan._backward(ctx, g_ys, g_yf)

    @staticmethod
    def _backward(ctx, g_ys, g_yf):
        a, ys, y0 = ctx.saved_tensors
        g = torch.zeros_like(ys) if g_ys is None else g_ys.clone()
        if g_yf is not None:
            g[-1] += g_yf
        a_rev = torch.cat([torch.zeros_like(a[:1]), a[1:].flip(0)])
        c_rev, _ = _scan.ssm_scan(a_rev, g.flip(0).contiguous(),
                                  torch.zeros_like(y0))
        del g
        c = c_rev.flip(0)
        del c_rev
        rep = _scan.repeat_factor(a, ys)
        grad_a = grad_b = grad_y0 = None
        if ctx.needs_input_grad[0]:
            y_prev = torch.cat([y0[None], ys[:-1]])
            grad_a = (c * y_prev).view(a.shape[0], a.shape[1], rep).sum(-1)
            del y_prev
        if ctx.needs_input_grad[2]:
            grad_y0 = a[0].repeat_interleave(rep) * c[0]
        if ctx.needs_input_grad[1]:
            grad_b = c.contiguous()
        return grad_a, grad_b, grad_y0


def ssm_scan(a, b, y0):
    """y_t = a_t * y_{t-1} + b_t over (T,D); `a` is (T,D) or a compact
    (T,D/R) shared by R neighbouring channels. Returns (ys, y_final)."""
    if COUNTER is not None:
        return COUNTER.kernel("ssm_scan", a, b, y0)
    with span("ssm_scan_forward"):
        if b.device.type == "cpu":
            rep = _scan.repeat_factor(a, b)
            return ref.ssm_scan_ref(a.repeat_interleave(rep, dim=1), b, y0)
        return _SsmScan.apply(a, b, y0)
