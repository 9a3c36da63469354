"""Approximate arithmetic unit families on int32 tensors.

Every unit is an elementwise function on int32 tensors; the families and
their parameters follow `repro.accel.units` (TRUNC/LOA/LOX/ACA/SEG adders
and subtractors; RTRUNC/OTRUNC/BROKEN/MITCHELL/DRUM multipliers;
ITRUNC/PWL/NEWTON sqrt).

Powers of two and ``floor(log2 x)`` follow the reference's float32
arithmetic as XLA evaluates it on the CPU: ``exp2(x)`` is
``exp(x * ln 2)`` and ``log2(x)`` is ``log(x) / ln 2`` in float32, which
are inexact at some integer arguments (``exp2(15.)`` gives 32767.984).
The mitchell, drum, pwl and newton units inherit those roundings, so
every truth table equals the reference's bit for bit, the k-means
tables included (tests/test_torch_accel.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Tuple

import torch


@dataclass(frozen=True)
class UnitKind:
    op: str          # add | sub | mul | sqrt
    width_a: int
    width_b: int     # 0 for sqrt

    @property
    def name(self) -> str:
        if self.op == "mul" and self.width_a != self.width_b:
            return f"mul{self.width_a}x{self.width_b}"
        if self.op == "sqrt":
            return f"sqrt{self.width_a}"
        return f"{self.op}{self.width_a}"


ADD8 = UnitKind("add", 8, 8)
ADD12 = UnitKind("add", 12, 12)
ADD16 = UnitKind("add", 16, 16)
SUB10 = UnitKind("sub", 10, 10)
MUL8 = UnitKind("mul", 8, 8)
MUL8X4 = UnitKind("mul", 8, 4)
SQRT18 = UnitKind("sqrt", 18, 0)

KINDS = {k.name: k for k in (ADD8, ADD12, ADD16, SUB10, MUL8, MUL8X4, SQRT18)}


def _mask(k: int) -> int:
    return (1 << k) - 1


# --------------------------------------------------------------------------
# adders / subtractors
# --------------------------------------------------------------------------

def add_exact(a, b, n):
    return a + b


def add_trunc(a, b, n, k):
    return ((a >> k) + (b >> k)) << k


def add_loa(a, b, n, k):
    lower = (a | b) & _mask(k)
    return (((a >> k) + (b >> k)) << k) | lower


def add_aca(a, b, n, k):
    """Approximate carry: carry into the upper part is a_{k-1} & b_{k-1}."""
    carry = (a >> (k - 1)) & (b >> (k - 1)) & 1
    lower = (a + b) & _mask(k)
    return (((a >> k) + (b >> k) + carry) << k) | lower


def add_lox(a, b, n, k):
    """LOA variant: lower k bits XOR'ed (no carry generate at all)."""
    lower = (a ^ b) & _mask(k)
    return (((a >> k) + (b >> k)) << k) | lower


def add_seg(a, b, n, k):
    """Segmented (ETAII-like): carry chains cut every k bits."""
    out = torch.zeros_like(a)
    for lo in range(0, n, k):
        sa = (a >> lo) & _mask(k)
        sb = (b >> lo) & _mask(k)
        out = out | (((sa + sb) & _mask(k)) << lo)
    # keep the top segment's carry-out so magnitude is preserved
    top = n - (n % k or k)
    return (out & _mask(top)) | (((a >> top) + (b >> top)) << top)


def sub_exact(a, b, n):
    return a - b


def sub_trunc(a, b, n, k):
    return ((a >> k) - (b >> k)) << k


def sub_loa(a, b, n, k):
    lower = (a ^ b) & _mask(k)
    return (((a >> k) - (b >> k)) << k) | lower


# --------------------------------------------------------------------------
# multipliers
# --------------------------------------------------------------------------

def mul_exact(a, b, na, nb):
    return a * b


def mul_rtrunc(a, b, na, nb, k):
    return ((a * b) >> k) << k


def mul_otrunc(a, b, na, nb, ka, kb):
    return ((a >> ka) * (b >> kb)) << (ka + kb)


def mul_broken(a, b, na, nb, k):
    """Broken-array: the k least-significant partial-product rows dropped."""
    return a * ((b >> k) << k)


_LN2 = torch.tensor(math.log(2.0), dtype=torch.float32)


def _exp2(x):
    """2^x of a float32 tensor as XLA's CPU ``exp2``: exp(x * ln 2)."""
    return torch.exp(x * _LN2)


def _ilog2(x):
    """floor(log2(max(x, 1))) of int32 x as the reference computes it,
    with XLA's CPU ``log2``: float32 log(x) / ln 2."""
    xf = torch.clamp(x, min=1).to(torch.float32)
    return torch.floor(torch.log(xf) / _LN2).to(torch.int32)


def mul_mitchell(a, b, na, nb, c):
    """Mitchell log multiplier with c correction bits on the fraction add."""
    za = _ilog2(a)
    zb = _ilog2(b)
    fa = a.to(torch.float32) / _exp2(za.to(torch.float32)) - 1.0
    fb = b.to(torch.float32) / _exp2(zb.to(torch.float32)) - 1.0
    if c > 0:  # quantize fractions to c bits (the "correction" datapath width)
        q = float(1 << c)
        fa = torch.floor(fa * q) / q
        fb = torch.floor(fb * q) / q
    s = fa + fb
    e = (za + zb).to(torch.float32)
    approx = torch.where(s < 1.0, _exp2(e) * (1.0 + s), _exp2(e + 1.0) * s)
    approx = torch.where((a == 0) | (b == 0), 0.0, approx)
    return approx.to(torch.int32)


def mul_drum(a, b, na, nb, m):
    """DRUM: keep the m MSBs of each operand, set dropped LSB for unbiasing."""
    def trim(x):
        sh = torch.clamp(_ilog2(x) - (m - 1), min=0)
        return (((x >> sh) | 1) << sh) * (x > 0)
    return trim(a) * trim(b)


# --------------------------------------------------------------------------
# sqrt
# --------------------------------------------------------------------------

def _isqrt_exact(x):
    """Integer sqrt via float + fixup (exact for x < 2^24)."""
    r = torch.floor(torch.sqrt(x.to(torch.float32))).to(torch.int32)
    r = torch.where((r + 1) * (r + 1) <= x, r + 1, r)
    r = torch.where(r * r > x, r - 1, r)
    return torch.clamp(r, min=0)


def sqrt_exact(x, n):
    return _isqrt_exact(x)


def sqrt_itrunc(x, n, k):
    """sqrt(x >> 2k) << k — drops 2k input LSBs."""
    return _isqrt_exact(x >> (2 * k)) << k


def sqrt_pwl(x, n, seg):
    """Piecewise-linear: r = 2^(z/2) * (1 + f/2) with f quantized to `seg`,
    in float32 as the reference."""
    z = _ilog2(x)
    f = x.to(torch.float32) / _exp2(z.to(torch.float32)) - 1.0
    if seg > 0:
        q = float(1 << seg)
        f = torch.floor(f * q) / q
    r = _exp2(z.to(torch.float32) / 2.0) * (1.0 + f / 2.0)
    return torch.where(x == 0, 0, r.to(torch.int32))


def sqrt_newton(x, n, seg):
    """One Newton step from the PWL seed, in float32 as the reference."""
    r0 = torch.clamp(sqrt_pwl(x, n, seg).to(torch.float32), min=1.0)
    r = 0.5 * (r0 + x.to(torch.float32) / r0)
    return torch.where(x == 0, 0, r.to(torch.int32))


# --------------------------------------------------------------------------
# config-batched dispatch (batched ground-truth labeling)
# --------------------------------------------------------------------------

# family ids for the analytic per-config adder/subtractor dispatch of the
# batched functional model; multipliers and sqrt go through LUT tables
FAM_IDS = {"exact": 0, "trunc": 1, "loa": 2, "lox": 3, "aca": 4, "seg": 5}


def seg_kill_mask(n: int, k: int) -> int:
    """Carry-kill mask for `add_seg(n, k)`: one bit below every segment
    boundary (multiples of ``k`` strictly inside the ``n``-bit word)."""
    return sum(1 << (c - 1) for c in range(k, n, k))


def addsub_batched(op: str, n: int, fam, k, seg_mask, a, b):
    """Approximate add/sub with the library choice as per-config tensors.

    ``fam``/``k``/``seg_mask`` are int32 tensors that broadcast against
    ``a``/``b`` (family id from FAM_IDS, cut parameter, `seg_kill_mask`).
    Each branch is the scalar family's expression; the shift amounts are
    sanitised (``k_t``, ``k1``) so that no branch shifts by an amount
    outside [0, 31], which C++ and torch leave undefined. ``seg``'s
    per-segment loop becomes a SWAR partitioned add: clearing the bit below
    each boundary in both operands stops the carry from crossing it, and
    the xor restores that bit's true sum.
    """
    if op == "sub":
        k_t = torch.where(fam == FAM_IDS["trunc"], k, 0)
        res = ((a >> k_t) - (b >> k_t)) << k_t       # exact == trunc @ k=0
        loa = (((a >> k) - (b >> k)) << k) | ((a ^ b) & ((1 << k) - 1))
        return torch.where(fam == FAM_IDS["loa"], loa, res)
    if op != "add":
        raise ValueError(f"addsub_batched handles add/sub, not {op!r}")
    k_t = torch.where(fam == FAM_IDS["trunc"], k, 0)
    res = ((a >> k_t) + (b >> k_t)) << k_t           # exact == trunc @ k=0
    upper = ((a >> k) + (b >> k)) << k
    m = (1 << k) - 1
    res = torch.where(fam == FAM_IDS["loa"], upper | ((a | b) & m), res)
    res = torch.where(fam == FAM_IDS["lox"], upper | ((a ^ b) & m), res)
    k1 = torch.clamp(k, min=1)                       # aca needs k >= 1
    carry = (a >> (k1 - 1)) & (b >> (k1 - 1)) & 1
    aca = ((((a >> k1) + (b >> k1)) + carry) << k1) | (
        (a + b) & ((1 << k1) - 1))
    res = torch.where(fam == FAM_IDS["aca"], aca, res)
    seg = ((a & ~seg_mask) + (b & ~seg_mask)) ^ ((a ^ b) & seg_mask)
    return torch.where(fam == FAM_IDS["seg"], seg, res)


# --------------------------------------------------------------------------
# instance descriptor
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class UnitInstance:
    kind: UnitKind
    family: str
    level: int       # approximation level, 0 = exact
    param: Tuple[int, ...] = ()

    @property
    def name(self) -> str:
        p = "_".join(str(x) for x in self.param)
        return f"{self.kind.name}_{self.family}" + (f"_{p}" if p else "")

    def fn(self) -> Callable:
        k = self.kind
        fam, prm = self.family, self.param
        na, nb = k.width_a, k.width_b
        if k.op == "add":
            table = {"exact": add_exact, "trunc": add_trunc, "loa": add_loa,
                     "lox": add_lox, "aca": add_aca, "seg": add_seg}
            f = table[fam]
            return lambda a, b: f(a, b, na, *prm)
        if k.op == "sub":
            f = {"exact": sub_exact, "trunc": sub_trunc, "loa": sub_loa}[fam]
            return lambda a, b: f(a, b, na, *prm)
        if k.op == "mul":
            f = {"exact": mul_exact, "rtrunc": mul_rtrunc,
                 "otrunc": mul_otrunc, "broken": mul_broken,
                 "mitchell": mul_mitchell, "drum": mul_drum}[fam]
            return lambda a, b: f(a, b, na, nb, *prm)
        # sqrt (unary: b ignored)
        f = {"exact": sqrt_exact, "itrunc": sqrt_itrunc, "pwl": sqrt_pwl,
             "newton": sqrt_newton}[fam]
        return lambda a, b=None: f(a, na, *prm)

    def lut(self, ea: int | None = None, eb: int | None = None
            ) -> torch.Tensor:
        """Truth table over a (possibly widened) input domain, computed on
        the CPU: (2^(ea+eb),) int32, entry ``(a << eb) | b``. ``ea``/``eb``
        default to the kind's widths; unary sqrt tables use ``eb=0``."""
        ea = self.kind.width_a if ea is None else ea
        eb = self.kind.width_b if eb is None else eb
        fn = self.fn()
        if self.kind.op == "sqrt":
            return fn(torch.arange(1 << ea, dtype=torch.int32)).to(
                torch.int32)
        a = torch.arange(1 << ea, dtype=torch.int32).repeat_interleave(
            1 << eb)
        b = torch.arange(1 << eb, dtype=torch.int32).repeat(1 << ea)
        return fn(a, b).to(torch.int32)
