"""Benchmark accelerators: Sobel, Gaussian, K-means, DCT-8, FIR-15.

Each accelerator is a dataflow graph over physical arithmetic-unit
instances plus fixed components, and a functional model in which one
physical unit serves every operation mapped onto it — the same graphs and
models as `repro.accel.apps`. Accuracy is mean SSIM between approximate
and exact outputs on the image set.

The functional models take ``impls`` (unit id -> callable) and int32
images with any leading dims; a constant operand (Gaussian taps, FIR
weights, DCT cosines, k-means centres) is handed to the unit as a Python
int, which lets the batched model gather from one column of the unit's
table without inspecting device data.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.accel import library as lib
from repro_torch.accel import units as units_lib
from repro_torch.kernels import ops as kernel_ops


@dataclass(frozen=True)
class Node:
    id: str
    kind: str                 # unit kind ("add8"...) or fixed kind
    fixed: bool = False


@dataclass(frozen=True)
class AccelDef:
    name: str
    nodes: Tuple[Node, ...]
    edges: Tuple[Tuple[str, str], ...]
    run: Callable                 # (impls: {unit_id: fn}, images) -> images

    @property
    def unit_nodes(self) -> List[Node]:
        return [n for n in self.nodes if not n.fixed]

    def space_size(self, counts=None) -> float:
        s = 1.0
        L = lib.TABLE_III if counts is None else counts
        for n in self.unit_nodes:
            s *= L[n.kind]
        return s


def _win(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """3x3 neighbour with wrap-around; img: (..., H, W) int32."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))


# --------------------------------------------------------------------------
# Sobel
# --------------------------------------------------------------------------

def _sobel_run(impls: Dict[str, Callable], images: torch.Tensor
               ) -> torch.Tensor:
    """images: (..., H, W) grayscale int32 [0,255] -> edge magnitude."""
    g = images
    p = {(dy, dx): _win(g, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)}
    a8_1, a8_2 = impls["a8_1"], impls["a8_2"]
    a12_1, a12_2, s10 = impls["a12_1"], impls["a12_2"], impls["s10"]
    gxp = a12_1(a8_1(p[(-1, 1)], p[(1, 1)]), p[(0, 1)] << 1)
    gxn = a12_1(a8_1(p[(-1, -1)], p[(1, -1)]), p[(0, -1)] << 1)
    gyp = a12_2(a8_2(p[(1, -1)], p[(1, 1)]), p[(1, 0)] << 1)
    gyn = a12_2(a8_2(p[(-1, -1)], p[(-1, 1)]), p[(-1, 0)] << 1)
    gx = torch.abs(s10(gxp, gxn))        # abs is fixed logic
    gy = torch.abs(s10(gyp, gyn))
    mag = a12_2(gx, gy)                  # reuse a12_2 for |gx|+|gy|
    return torch.clamp(mag >> 3, 0, 255)


SOBEL = AccelDef(
    name="sobel",
    nodes=(
        Node("img_mem", "mem", fixed=True),
        Node("a8_1", "add8"), Node("a8_2", "add8"),
        Node("a12_1", "add12"), Node("a12_2", "add12"),
        Node("s10", "sub10"),
        Node("abs1", "abs", fixed=True), Node("abs2", "abs", fixed=True),
        Node("out_mem", "mem", fixed=True),
    ),
    edges=(
        ("img_mem", "a8_1"), ("img_mem", "a8_2"),
        ("img_mem", "a12_1"), ("img_mem", "a12_2"),
        ("a8_1", "a12_1"), ("a8_2", "a12_2"),
        ("a12_1", "s10"), ("a12_2", "s10"),
        ("s10", "abs1"), ("s10", "abs2"),
        ("abs1", "a12_2"), ("abs2", "a12_2"),
        ("a12_2", "out_mem"),
    ),
    run=_sobel_run,
)


# --------------------------------------------------------------------------
# Gaussian 3x3 (coeffs 1,2,1 / 2,4,2 / 1,2,1, /16)
# --------------------------------------------------------------------------

_GAUSS_W = {(-1, -1): 1, (-1, 0): 2, (-1, 1): 1,
            (0, -1): 2, (0, 0): 4, (0, 1): 2,
            (1, -1): 1, (1, 0): 2, (1, 1): 1}


def _gauss_run(impls: Dict[str, Callable], images: torch.Tensor
               ) -> torch.Tensor:
    g = images
    m = [impls[f"m{i}"](_win(g, dy, dx), w)
         for i, ((dy, dx), w) in enumerate(_GAUSS_W.items())]
    a = impls
    t1 = a["a0"](m[0], m[1])
    t2 = a["a1"](m[2], m[3])
    t3 = a["a2"](m[4], m[5])
    t4 = a["a3"](m[6], m[7])
    t5 = a["a4"](t1, t2)
    t6 = a["a5"](t3, t4)
    t7 = a["a6"](t5, t6)
    t8 = a["a7"](t7, m[8])
    return torch.clamp(t8 >> 4, 0, 255)


GAUSSIAN = AccelDef(
    name="gaussian",
    nodes=tuple(
        [Node("img_mem", "mem", fixed=True), Node("coeff_rom", "mem", fixed=True)]
        + [Node(f"m{i}", "mul8x4") for i in range(9)]
        + [Node(f"a{i}", "add16") for i in range(8)]
        + [Node("shift", "shift", fixed=True), Node("out_mem", "mem", fixed=True)]),
    edges=tuple(
        [("img_mem", f"m{i}") for i in range(9)]
        + [("coeff_rom", f"m{i}") for i in range(9)]
        + [("m0", "a0"), ("m1", "a0"), ("m2", "a1"), ("m3", "a1"),
           ("m4", "a2"), ("m5", "a2"), ("m6", "a3"), ("m7", "a3"),
           ("a0", "a4"), ("a1", "a4"), ("a2", "a5"), ("a3", "a5"),
           ("a4", "a6"), ("a5", "a6"), ("a6", "a7"), ("m8", "a7"),
           ("a7", "shift"), ("shift", "out_mem")]),
    run=_gauss_run,
)


# --------------------------------------------------------------------------
# K-means (2 clusters x RGB, one assignment pass, AxBench-style segmentation)
# --------------------------------------------------------------------------

_CENTERS = np.array([[70, 80, 90], [180, 170, 160]], np.int32)


def _kmeans_run(impls: Dict[str, Callable], images: torch.Tensor
                ) -> torch.Tensor:
    """images: (..., H, W, 3) int32 RGB -> segmented grayscale (..., H, W)."""
    dists = []
    for c in range(2):
        sq = []
        for j, ch in enumerate("rgb"):
            d = impls[f"s_{c}{ch}"](images[..., j], int(_CENTERS[c, j]))
            d = torch.abs(d)                        # fixed abs
            sq.append(impls[f"m_{c}{ch}"](d, d) >> 2)   # fixed >>2 rescale
        acc = impls[f"a_{c}"](sq[0], sq[1])
        acc = impls[f"a_{c}"](acc, sq[2])           # physical adder reused
        dists.append(impls[f"q_{c}"](acc << 2, None))
    assign = (dists[1] < dists[0]).long()           # fixed comparator
    gray_centers = torch.from_numpy(
        _CENTERS.mean(axis=1).astype(np.int32)).to(images.device)
    return gray_centers[assign]


KMEANS = AccelDef(
    name="kmeans",
    nodes=tuple(
        [Node("img_mem", "mem", fixed=True), Node("cluster_mem", "mem", fixed=True),
         Node("center_mem1", "mem", fixed=True), Node("center_mem2", "mem", fixed=True),
         Node("center_mem3", "mem", fixed=True)]
        + [Node(f"s_{c}{ch}", "sub10") for c in range(2) for ch in "rgb"]
        + [Node(f"m_{c}{ch}", "mul8") for c in range(2) for ch in "rgb"]
        + [Node(f"a_{c}", "add16") for c in range(2)]
        + [Node(f"q_{c}", "sqrt18") for c in range(2)]
        + [Node("div1", "div", fixed=True), Node("div2", "div", fixed=True),
           Node("div3", "div", fixed=True), Node("cmp", "cmp", fixed=True)]),
    edges=tuple(
        [("img_mem", f"s_{c}{ch}") for c in range(2) for ch in "rgb"]
        + [(f"center_mem{j + 1}", f"s_{c}{ch}")
           for c in range(2) for j, ch in enumerate("rgb")]
        + [(f"s_{c}{ch}", f"m_{c}{ch}") for c in range(2) for ch in "rgb"]
        + [(f"m_{c}{ch}", f"a_{c}") for c in range(2) for ch in "rgb"]
        + [(f"a_{c}", f"q_{c}") for c in range(2)]
        + [(f"q_{c}", "cmp") for c in range(2)]
        + [("cmp", "cluster_mem")]
        + [("cluster_mem", f"div{j}") for j in (1, 2, 3)]
        + [(f"div{j}", f"center_mem{j}") for j in (1, 2, 3)]),
    run=_kmeans_run,
)

# --------------------------------------------------------------------------
# DCT-8 (2D 8x8 block transform, even/odd butterfly decomposition)
# --------------------------------------------------------------------------

# C[u,k] = alpha(u) cos((2k+1) u pi / 16), alpha(0)=sqrt(1/8) else 1/2,
# quantized to 4-bit magnitudes (scale 29 -> |c| <= 15); even-u rows use
# the butterfly sums s_k = x_k + x_{7-k}, odd-u rows the differences.
_DCT_SCALE = 29
_DCT_C = np.round(np.array(
    [[(1.0 / np.sqrt(8) if u == 0 else 0.5)
      * np.cos((2 * k + 1) * u * np.pi / 16) for k in range(4)]
     for u in range(8)]) * _DCT_SCALE).astype(np.int32)


def _signed_mul(impl: Callable, x: torch.Tensor, c: int) -> torch.Tensor:
    """Sign-magnitude use of an unsigned multiplier: |x| * |c| through the
    physical unit, sign reapplied by fixed logic."""
    p = impl(torch.abs(x), abs(c))
    neg = (x < 0) if c >= 0 else (x >= 0)
    return torch.where(neg, -p, p)


def _dct8_1d(impls: Dict[str, Callable], v: torch.Tensor) -> torch.Tensor:
    """1D DCT-8 along the last axis (length 8); v signed int32."""
    s = [impls[f"b{k}"](v[..., k], v[..., 7 - k]) for k in range(4)]
    d = [impls[f"d{k}"](v[..., k], v[..., 7 - k]) for k in range(4)]
    outs = []
    for u in range(8):
        src = s if u % 2 == 0 else d
        prods = [_signed_mul(impls[f"m{k}"], src[k], int(_DCT_C[u, k]))
                 for k in range(4)]
        t0 = impls["a0"](prods[0], prods[1])
        t1 = impls["a1"](prods[2], prods[3])
        outs.append(impls["a2"](t0, t1))
    return torch.stack(outs, -1)


def _dct8_run(impls: Dict[str, Callable], images: torch.Tensor
              ) -> torch.Tensor:
    """images: (..., H, W) grayscale int32 -> 2D DCT coefficient blocks
    (the same physical butterfly streams the row pass, then the column
    pass)."""
    lead, (H, W) = images.shape[:-2], images.shape[-2:]
    h8, w8 = (H // 8) * 8, (W // 8) * 8
    g = images[..., :h8, :w8]
    rows = g.reshape(*lead, h8, w8 // 8, 8)
    rowed = _dct8_1d(impls, rows) >> 6              # fixed rescale shift
    lead = rowed.shape[:-3]                         # gains the config axis
    t = rowed.reshape(*lead, h8, w8).transpose(-1, -2)
    cols = t.reshape(*lead, w8, h8 // 8, 8)
    coled = _dct8_1d(impls, cols) >> 6
    out = coled.reshape(*lead, w8, h8).transpose(-1, -2)
    return torch.clamp(out, -255, 255)


DCT8 = AccelDef(
    name="dct8",
    nodes=tuple(
        [Node("img_mem", "mem", fixed=True),
         Node("coeff_rom", "mem", fixed=True)]
        + [Node(f"b{k}", "add8") for k in range(4)]
        + [Node(f"d{k}", "sub10") for k in range(4)]
        + [Node(f"m{k}", "mul8x4") for k in range(4)]
        + [Node(f"a{k}", "add16") for k in range(3)]
        + [Node("shift", "shift", fixed=True),
           Node("out_mem", "mem", fixed=True)]),
    edges=tuple(
        [("img_mem", f"b{k}") for k in range(4)]
        + [("img_mem", f"d{k}") for k in range(4)]
        + [("coeff_rom", f"m{k}") for k in range(4)]
        + [(f"b{k}", f"m{k}") for k in range(4)]     # even-pass operands
        + [(f"d{k}", f"m{k}") for k in range(4)]     # odd-pass operands
        + [("m0", "a0"), ("m1", "a0"), ("m2", "a1"), ("m3", "a1"),
           ("a0", "a2"), ("a1", "a2"),
           ("a2", "shift"), ("shift", "out_mem")]),
    run=_dct8_run,
)


# --------------------------------------------------------------------------
# FIR-15 (symmetric 15-tap lowpass, pre-add folding + reused adder tree)
# --------------------------------------------------------------------------

# triangular window, sum 64; pair taps k and -k share coefficient k+1,
# center tap weight 8 — all 4-bit magnitudes for the mul8x4 port
_FIR_W = (1, 2, 3, 4, 5, 6, 7, 8)


def _fir15_run(impls: Dict[str, Callable], images: torch.Tensor
               ) -> torch.Tensor:
    """images: (..., H, W) grayscale int32 -> horizontally lowpassed."""
    g = images
    tap = {k: torch.roll(g, -k, dims=-1) for k in range(-7, 8)}
    pre = [impls[f"p{k}"](tap[k - 7], tap[7 - k]) for k in range(7)]
    prods = [impls[f"m{k}"](pre[k], _FIR_W[k]) for k in range(7)]
    prods.append(impls["m7"](tap[0], _FIR_W[7]))
    t1 = impls["a0"](prods[0], prods[1])
    t2 = impls["a1"](prods[2], prods[3])
    t3 = impls["a2"](prods[4], prods[5])
    t4 = impls["a3"](prods[6], prods[7])
    t5 = impls["a0"](t1, t2)                        # physical adders reused
    t6 = impls["a1"](t3, t4)
    y = impls["a2"](t5, t6)
    return torch.clamp(y >> 6, 0, 255)


FIR15 = AccelDef(
    name="fir15",
    nodes=tuple(
        [Node("img_mem", "mem", fixed=True),
         Node("coeff_rom", "mem", fixed=True)]
        + [Node(f"p{k}", "add8") for k in range(7)]
        + [Node(f"m{k}", "mul8x4") for k in range(8)]
        + [Node(f"a{k}", "add16") for k in range(4)]
        + [Node("shift", "shift", fixed=True),
           Node("out_mem", "mem", fixed=True)]),
    edges=tuple(
        [("img_mem", f"p{k}") for k in range(7)]
        + [("img_mem", "m7")]                        # center tap
        + [("coeff_rom", f"m{k}") for k in range(8)]
        + [(f"p{k}", f"m{k}") for k in range(7)]
        + [("m0", "a0"), ("m1", "a0"), ("m2", "a1"), ("m3", "a1"),
           ("m4", "a2"), ("m5", "a2"), ("m6", "a3"), ("m7", "a3"),
           ("a1", "a0"),                             # t5 = a0(t1, t2)
           ("a2", "a1"), ("a3", "a1"),               # t6 = a1(t3, t4)
           ("a0", "a2"), ("a1", "a2"),               # y  = a2(t5, t6)
           ("a2", "shift"), ("shift", "out_mem")]),
    run=_fir15_run,
)

APPS: Dict[str, AccelDef] = {"sobel": SOBEL, "gaussian": GAUSSIAN,
                             "kmeans": KMEANS, "dct8": DCT8, "fir15": FIR15}


# --------------------------------------------------------------------------
# configuration -> functional model + SSIM accuracy
# --------------------------------------------------------------------------

def make_impls(app: AccelDef, choice: Dict[str, lib.LibEntry]
               ) -> Dict[str, Callable]:
    """One configuration's unit callables (a constant operand may be an
    int)."""
    def wrap(fn, unary):
        if unary:
            return lambda a, b=None: fn(a)
        return lambda a, b: fn(a, b if torch.is_tensor(b)
                               else torch.full_like(a, b))
    return {n.id: wrap(choice[n.id].inst.fn(),
                       choice[n.id].inst.kind.op == "sqrt")
            for n in app.unit_nodes}


def exact_choice(app: AccelDef) -> Dict[str, lib.LibEntry]:
    return {n.id: lib.build_library(n.kind)[0] for n in app.unit_nodes}


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 255.0
         ) -> torch.Tensor:
    """Mean SSIM with 8x8 uniform windows over the last three dims
    (images, H, W); leading dims (a config axis) are kept. a and b
    broadcast against each other."""
    a, b = torch.broadcast_tensors(a.to(torch.float32), b.to(torch.float32))
    lead, (H, W) = a.shape[:-2], a.shape[-2:]
    h8, w8 = (H // 8) * 8, (W // 8) * 8
    aw = a[..., :h8, :w8].reshape(*lead, h8 // 8, 8, w8 // 8, 8)
    bw = b[..., :h8, :w8].reshape(*lead, h8 // 8, 8, w8 // 8, 8)
    ax = (-3, -1)
    mu_a = aw.mean(ax)
    mu_b = bw.mean(ax)
    var_a = aw.var(ax, correction=0)
    var_b = bw.var(ax, correction=0)
    cov = (aw * bw).mean(ax) - mu_a * mu_b
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return s.mean((-3, -2, -1))


def accuracy_ssim(app: AccelDef, choice: Dict[str, lib.LibEntry],
                  images: torch.Tensor,
                  exact_out: torch.Tensor | None = None) -> float:
    """SSIM of one configuration: the scalar functional model (one unit
    callable per node, `make_impls`) on ``images``' device against the
    exact design's output. The reference path of the batched
    `accuracy_ssim_batch`."""
    approx = app.run(make_impls(app, choice), images)
    if exact_out is None:
        exact_out = app.run(make_impls(app, exact_choice(app)), images)
    return float(ssim(approx, exact_out))


# --------------------------------------------------------------------------
# functional probe (schema-v2 dynamic features)
# --------------------------------------------------------------------------
#
# The probe runs the real config-batched functional model on one tiny
# image per scale and reports the distortion 1 - SSIM: graph-level
# features that carry the composed error structure no per-unit table can.

PROBE_SIZES = (8, 16)
PROBE_SEED = 77
PROBE_FIELDS = tuple(f"probe_err{s}" for s in PROBE_SIZES)


def app_inputs(app_name: str, imgs: np.ndarray, device) -> torch.Tensor:
    """The app's int32 input tensor for an RGB image set: RGB for
    k-means, grayscale for the others."""
    from repro_torch.data import images as images_lib
    x = imgs.astype(np.int32) if app_name == "kmeans" \
        else images_lib.gray(imgs)
    return torch.from_numpy(x).to(device)


@functools.lru_cache(maxsize=None)
def _probe_inputs(app_name: str, size: int, device: str):
    from repro_torch.data import images as images_lib
    app = APPS[app_name]
    inp = app_inputs(app_name, images_lib.image_set(1, size, seed=PROBE_SEED),
                     device)
    return inp, app.run(make_impls(app, exact_choice(app)), inp)


def probe_inputs(app_name: str, size: int, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images, exact_out) for the functional probe at one scale —
    deterministic (PROBE_SEED), computed once per (app, size, device)."""
    return _probe_inputs(app_name, size, str(device_lib.resolve(device)))


def probe_scalar(app: AccelDef, choice: Dict[str, lib.LibEntry],
                 device=None) -> Dict[str, float]:
    """Probe distortions {probe_err8, probe_err16} of one configuration
    through the scalar functional model on ``device`` (the loop labeling
    backend; the batched path is `batch_oracle.probe_batch`)."""
    out = {}
    for size in PROBE_SIZES:
        inp, exact_out = probe_inputs(app.name, size, device)
        out[f"probe_err{size}"] = 1.0 - accuracy_ssim(app, choice, inp,
                                                      exact_out)
    return out


# --------------------------------------------------------------------------
# config-batched functional model (batched ground-truth labeling)
# --------------------------------------------------------------------------
#
# A (B, n_units) block of configurations runs through ONE pass of the
# functional model with a written-out config axis: the images get a
# leading axis of 1 and each unit broadcasts its per-config choice over it.
#   * multipliers and sqrt gather from stacked truth tables
#     (`library.stacked_lut`) with the per-config library choice folded
#     into the table index, through `kernels.ops.lut_eval` (the CUDA
#     kernel on the card, the plain gather on the CPU);
#   * adders/subtractors, whose widened tables would need 2^24-2^32
#     entries, are evaluated analytically (`units.addsub_batched`).


class LutDomainError(RuntimeError):
    """An app drove a LUT-tabulated unit outside its table domain."""


def _entries_items(app: AccelDef, entries: Dict[str, Sequence]
                   ) -> Tuple[Tuple[str, Tuple[lib.LibEntry, ...]], ...]:
    """Hashable (kind, entries) signature restricted to the app's kinds."""
    kinds = {n.kind for n in app.unit_nodes}
    return tuple(sorted((k, tuple(entries[k])) for k in kinds))


def _per_config(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) per-config values shaped to broadcast over ``like``'s config
    axis (its leading dim)."""
    return v.view(-1, *([1] * (like.dim() - 1)))


def _excess(x: torch.Tensor, bits: int) -> torch.Tensor:
    """> 0 iff some element of x leaves [0, 2^bits), by how much."""
    return torch.maximum(-x, x - ((1 << bits) - 1)).max()


class _LutUnit:
    """A multiplier/sqrt node: gathers from its stacked truth table."""

    def __init__(self, node: Node, kind: units_lib.UnitKind, ea: int,
                 eb: int, table: torch.Tensor):
        self.node, self.kind, self.ea, self.eb = node, kind, ea, eb
        self.table = table
        self._columns: Dict[int, torch.Tensor] = {}

    def column(self, b: int) -> torch.Tensor:
        """Entry-major table of the constant operand ``b``: 2^ea per
        entry instead of 2^(ea+eb)."""
        col = self._columns.get(b)
        if col is None:
            col = self.table.view(-1, 1 << self.eb)[:, b].contiguous()
            self._columns[b] = col
        return col

    def impl(self, e: torch.Tensor, guards: list, counts: Dict[str, int]):
        e = e.to(torch.int32)

        def run(a, b=None):
            tag = f"{self.node.id}#{counts.setdefault(self.node.id, 0)}"
            counts[self.node.id] += 1
            ea, eb = self.ea, self.eb
            af = (_per_config(e, a) << ea) | a
            zero = torch.zeros((), dtype=torch.int32, device=a.device)
            if self.kind.op == "sqrt":
                guards.append((tag, self.kind.name, ea, eb,
                               _excess(a, ea), zero))
                flat = af.reshape(-1)
                out = kernel_ops.lut_eval(self.table, flat)
                return out.view(af.shape)
            if not torch.is_tensor(b) and 0 <= b < (1 << eb):
                guards.append((tag, self.kind.name, ea, eb,
                               _excess(a, ea), zero))
                flat = af.reshape(-1)
                out = kernel_ops.lut_eval(self.column(b), flat)
                return out.view(af.shape)
            if not torch.is_tensor(b):
                b = torch.full_like(a, b)
            guards.append((tag, self.kind.name, ea, eb, _excess(a, ea),
                           _excess(b, eb)))
            shape = torch.broadcast_shapes(af.shape, b.shape)
            out = kernel_ops.lut_eval(self.table,
                                      af.expand(shape).reshape(-1),
                                      b.expand(shape).reshape(-1), eb)
            return out.view(shape)
        return run


class _AddSubUnit:
    """An adder/subtractor node: analytic, per-config family/cut."""

    def __init__(self, kind: units_lib.UnitKind, fam, k, seg, device):
        self.kind = kind
        self.fam, self.k, self.seg = (torch.from_numpy(v).to(device)
                                      for v in (fam, k, seg))

    def impl(self, e: torch.Tensor, guards: list, counts: Dict[str, int]):
        fam, k, seg = self.fam[e], self.k[e], self.seg[e]

        def run(a, b):
            if not torch.is_tensor(b):
                b = torch.full_like(a, b)
            ref = a if a.dim() >= b.dim() else b
            return units_lib.addsub_batched(
                self.kind.op, self.kind.width_a, _per_config(fam, ref),
                _per_config(k, ref), _per_config(seg, ref), a, b)
        return run


@functools.lru_cache(maxsize=64)
def _batch_model(app_name: str, entries_items, device: str):
    """Units of one app for one library and device: the stacked tables
    and dispatch arrays, on the device, built once."""
    app = APPS[app_name]
    entries = dict(entries_items)
    units = []
    for node in app.unit_nodes:
        ent = tuple(entries[node.kind])
        kind = units_lib.KINDS[node.kind]
        if node.kind in lib.LUT_DOMAINS:
            ea, eb = lib.lut_domain(app_name, node.kind)
            units.append(_LutUnit(node, kind, ea, eb,
                                  lib.stacked_lut(ent, ea, eb).to(device)))
        else:
            units.append(_AddSubUnit(kind, *lib.addsub_dispatch(ent),
                                     device))
    return units


def _check_lut_guards(app: AccelDef, guards: list) -> None:
    if not guards:
        return
    over = torch.stack([torch.stack([ga, gb]) for *_, ga, gb in guards]
                       ).cpu().numpy()
    for (tag, kind_name, ea, eb, _, _), (over_a, over_b) in zip(guards, over):
        if over_a > 0 or over_b > 0:
            raise LutDomainError(
                f"{app.name}: unit {tag} ({kind_name}) left its LUT domain "
                f"(2^{ea}, 2^{eb}) by up to a:{max(int(over_a), 0)} "
                f"b:{max(int(over_b), 0)}; widen "
                f"repro_torch.accel.library.LUT_DOMAINS[{kind_name!r}] (or "
                f"the APP_LUT_DOMAINS override for {app.name!r})")


def batch_outputs(app: AccelDef, entries: Dict[str, Sequence], configs,
                  images: torch.Tensor) -> torch.Tensor:
    """Functional-model outputs of a config block, (B, *app output) int32
    on ``images``' device; raises `LutDomainError` if a tabulated unit saw
    an operand outside its table."""
    units = _batch_model(app.name, _entries_items(app, entries),
                         str(images.device))
    C = torch.as_tensor(np.asarray(configs, np.int64).reshape(
        len(configs), -1), device=images.device)
    guards: list = []
    counts: Dict[str, int] = {}
    impls = {u_node.id: unit.impl(C[:, j], guards, counts)
             for j, (u_node, unit) in enumerate(zip(app.unit_nodes, units))}
    out = app.run(impls, images.unsqueeze(0))
    _check_lut_guards(app, guards)
    return out.expand((C.shape[0],) + tuple(out.shape[1:]))


def accuracy_ssim_batch(app: AccelDef, entries: Dict[str, Sequence],
                        configs, images: torch.Tensor,
                        exact_out: torch.Tensor | None = None, *,
                        chunk: int = 256) -> np.ndarray:
    """SSIM labels for a batch of configurations: (B,) float64.

    ``configs`` is a (B, n_units) int block of library-entry indices (the
    `dataset.sample_configs` layout), evaluated ``chunk`` configurations
    at a time on ``images``' device."""
    if exact_out is None:
        exact_out = app.run(make_impls(app, exact_choice(app)), images)
    C = np.asarray(configs, np.int64).reshape(len(configs), -1)
    out = np.empty(C.shape[0], np.float64)
    for lo in range(0, C.shape[0], chunk):
        y = batch_outputs(app, entries, C[lo:lo + chunk], images)
        out[lo:lo + chunk] = ssim(y, exact_out).cpu().numpy()
    return out
