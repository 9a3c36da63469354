"""Approximate-operator library: generation + characterization.

The instance grids reproduce the paper's Table III counts:
    add8: 31   add12: 26   add16: 21   sub10: 12
    mul8: 35   mul8x4: 32  sqrt18: 7

Each instance is characterized by its error metrics against the exact op
(MAE, MRE, MSE, WCE: float32 terms, means taken in float64 and rounded to
float32, over exhaustive inputs where there are at most 2^20 pairs and a
fixed 2^16-pair sample otherwise) and by the
analytic PPA model with its sha256 per-instance jitter — the simulated
synthesis report of `repro.accel.library`, computed the same way.
Characterization runs on the CPU: it is set-up, done once per kind.
"""
from __future__ import annotations

import functools
import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.accel.units import (ADD8, ADD12, ADD16, FAM_IDS, KINDS,
                                     MUL8, MUL8X4, SQRT18, SUB10,
                                     UnitInstance, UnitKind, seg_kill_mask)


# --------------------------------------------------------------------------
# instance grids (ordered; library takes the first N of each kind)
# --------------------------------------------------------------------------

def _adder_grid(kind: UnitKind) -> List[UnitInstance]:
    n = kind.width_a
    out = [UnitInstance(kind, "exact", 0)]
    for fam in ("trunc", "loa", "lox", "aca", "seg"):
        lo = 1 if fam != "seg" else 2
        for k in range(lo, n):
            out.append(UnitInstance(kind, fam, k, (k,)))
    # interleave by level so truncation prefixes stay diverse
    return [out[0]] + sorted(out[1:], key=lambda u: (u.level, u.family))


def _sub_grid(kind: UnitKind) -> List[UnitInstance]:
    n = kind.width_a
    out = [UnitInstance(kind, "exact", 0)]
    for fam in ("trunc", "loa"):
        for k in range(1, n - 2):
            out.append(UnitInstance(kind, fam, k, (k,)))
    return [out[0]] + sorted(out[1:], key=lambda u: (u.level, u.family))


def _mul_grid(kind: UnitKind) -> List[UnitInstance]:
    na, nb = kind.width_a, kind.width_b
    out = [UnitInstance(kind, "exact", 0)]
    for k in range(1, na):
        out.append(UnitInstance(kind, "rtrunc", k, (k,)))
    for ka in range(0, min(na, 6)):
        for kb in range(0, min(nb, 4)):
            if ka == 0 and kb == 0:
                continue
            out.append(UnitInstance(kind, "otrunc", ka + kb, (ka, kb)))
    for k in range(1, min(nb, 5)):
        out.append(UnitInstance(kind, "broken", k, (k,)))
    for c in (0, 1, 2, 3):
        out.append(UnitInstance(kind, "mitchell", 8 - c, (c,)))
    for m in (3, 4, 5, 6):
        out.append(UnitInstance(kind, "drum", 8 - m, (m,)))
    return [out[0]] + sorted(out[1:], key=lambda u: (u.level, u.family))


def _sqrt_grid(kind: UnitKind) -> List[UnitInstance]:
    out = [UnitInstance(kind, "exact", 0)]
    for k in (1, 2, 3, 4):
        out.append(UnitInstance(kind, "itrunc", k, (k,)))
    out.append(UnitInstance(kind, "pwl", 6, (4,)))
    out.append(UnitInstance(kind, "newton", 2, (4,)))
    return out


TABLE_III = {"add8": 31, "add12": 26, "add16": 21, "sub10": 12,
             "mul8": 35, "mul8x4": 32, "sqrt18": 7}

_GRIDS = {"add8": _adder_grid(ADD8), "add12": _adder_grid(ADD12),
          "add16": _adder_grid(ADD16), "sub10": _sub_grid(SUB10),
          "mul8": _mul_grid(MUL8), "mul8x4": _mul_grid(MUL8X4),
          "sqrt18": _sqrt_grid(SQRT18)}


def instances(kind_name: str, count: int | None = None) -> List[UnitInstance]:
    grid = _GRIDS[kind_name]
    n = TABLE_III[kind_name] if count is None else count
    if n > len(grid):
        raise ValueError(f"grid for {kind_name} has only {len(grid)}")
    return grid[:n]


# --------------------------------------------------------------------------
# error characterization
# --------------------------------------------------------------------------

def _inputs_for(kind: UnitKind, max_exhaustive: int = 1 << 20
                ) -> Tuple[np.ndarray, np.ndarray]:
    na, nb = kind.width_a, kind.width_b
    if kind.op == "sqrt":
        a = np.arange(1 << min(na, 18), dtype=np.int32)
        return a, np.zeros_like(a)
    if 1 << (na + nb) <= max_exhaustive:
        a = np.repeat(np.arange(1 << na, dtype=np.int32), 1 << nb)
        b = np.tile(np.arange(1 << nb, dtype=np.int32), 1 << na)
        return a, b
    # deterministic sample (same generator and seed as the reference)
    rng = np.random.default_rng(0xA55A)
    n = 1 << 16
    return (rng.integers(0, 1 << na, n, dtype=np.int32),
            rng.integers(0, 1 << nb, n, dtype=np.int32))


@functools.lru_cache(maxsize=None)
def _char_inputs(kind_name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    a, b = _inputs_for(KINDS[kind_name])
    return torch.from_numpy(a), torch.from_numpy(b)


def error_metrics(inst: UnitInstance) -> Dict[str, float]:
    a, b = _char_inputs(inst.kind.name)
    exact = UnitInstance(inst.kind, "exact", 0).fn()(a, b)
    approx = inst.fn()(a, b)
    # the elementwise terms in float32, as the reference computes them;
    # the means in float64 by NumPy (one thread, a fixed order), rounded
    # to float32 once, so the metrics do not follow torch's thread count
    err = (approx - exact).to(torch.float32)
    denom = torch.clamp(exact.to(torch.float32).abs(), min=1.0)
    rel = (err.abs() / denom).numpy()

    def mean(x: np.ndarray) -> float:
        return float(np.float32(x.astype(np.float64).mean()))

    return {
        "mae": mean(err.abs().numpy()),
        "mre": mean(rel),
        "mse": mean((err * err).numpy()),
        "wce": float(rel.max()),
    }


# --------------------------------------------------------------------------
# analytic PPA model (the simulated synthesis report)
# --------------------------------------------------------------------------

_FA_AREA, _FA_DELAY, _FA_POWER = 4.5, 2.0, 2.5
_GATE_AREA, _GATE_DELAY, _GATE_POWER = 1.0, 0.6, 0.5


def _jitter(name: str, salt: str) -> float:
    h = int(hashlib.sha256(f"{name}:{salt}".encode()).hexdigest()[:8], 16)
    return 1.0 + ((h % 600) - 300) / 10_000.0          # +-3%


def ppa(inst: UnitInstance) -> Dict[str, float]:
    k = inst.kind
    n, m = k.width_a, k.width_b
    fam, prm = inst.family, inst.param
    if k.op in ("add", "sub"):
        cut = prm[0] if prm else 0
        if fam == "exact":
            area, delay, power = n * _FA_AREA, n * _FA_DELAY, n * _FA_POWER
        elif fam == "trunc":
            eff = n - cut
            area, delay, power = eff * _FA_AREA, eff * _FA_DELAY, eff * _FA_POWER
        elif fam in ("loa", "lox"):
            eff = n - cut
            area = eff * _FA_AREA + cut * _GATE_AREA
            delay = eff * _FA_DELAY + _GATE_DELAY
            power = eff * _FA_POWER + cut * _GATE_POWER
        elif fam == "aca":
            eff = n - cut
            area = eff * _FA_AREA + cut * _FA_AREA * 0.6 + _GATE_AREA
            delay = eff * _FA_DELAY + _GATE_DELAY
            power = eff * _FA_POWER + cut * _FA_POWER * 0.5
        else:  # seg
            seg = prm[0]
            area = n * _FA_AREA * 1.05
            delay = seg * _FA_DELAY + _GATE_DELAY
            power = n * _FA_POWER * 0.9
    elif k.op == "mul":
        cells = n * m
        base_delay = (n + m) * _FA_DELAY * 0.75
        if fam == "exact":
            area, delay, power = cells * _FA_AREA, base_delay, cells * _FA_POWER * 0.8
        elif fam == "rtrunc":
            kk = prm[0]
            eff = cells - kk * (kk + 1) // 2
            area = eff * _FA_AREA
            delay = base_delay * (1 - 0.3 * kk / (n + m))
            power = eff * _FA_POWER * 0.8
        elif fam == "otrunc":
            ka, kb = prm
            eff = (n - ka) * (m - kb)
            area = eff * _FA_AREA
            delay = (n - ka + m - kb) * _FA_DELAY * 0.75
            power = eff * _FA_POWER * 0.8
        elif fam == "broken":
            kk = prm[0]
            eff = n * (m - kk)
            area = eff * _FA_AREA
            delay = (n + m - kk) * _FA_DELAY * 0.75
            power = eff * _FA_POWER * 0.8
        elif fam == "mitchell":
            c = prm[0]
            area = (3 * (n + m) + c * 4) * _FA_AREA * 0.5
            delay = (math.log2(n) * 2 + c) * _FA_DELAY
            power = (2 * (n + m) + c * 3) * _FA_POWER * 0.4
        else:  # drum
            mm = prm[0]
            area = (mm * mm + 2 * (n + m)) * _FA_AREA * 0.7
            delay = (2 * mm + math.log2(n)) * _FA_DELAY * 0.8
            power = (mm * mm + n + m) * _FA_POWER * 0.6
    else:  # sqrt
        stages = n // 2
        if fam == "exact":
            area = stages * (n / 2) * _FA_AREA
            delay = stages * _FA_DELAY * 1.5
            power = stages * (n / 2) * _FA_POWER * 0.7
        elif fam == "itrunc":
            kk = prm[0]
            eff = (n - 2 * kk) // 2
            area = eff * (n / 2 - kk) * _FA_AREA
            delay = eff * _FA_DELAY * 1.5
            power = eff * (n / 2 - kk) * _FA_POWER * 0.7
        elif fam == "pwl":
            area = 4 * n * _FA_AREA * 0.4
            delay = (math.log2(n) + 3) * _FA_DELAY
            power = 3 * n * _FA_POWER * 0.3
        else:  # newton
            area = (4 * n + n * n / 8) * _FA_AREA * 0.5
            delay = (math.log2(n) + 8) * _FA_DELAY
            power = (3 * n + n * n / 10) * _FA_POWER * 0.4
    j = _jitter(inst.name, "ppa")
    return {"area": area * j, "power": power * j,
            "latency": delay * _jitter(inst.name, "lat")}


# --------------------------------------------------------------------------
# characterized library
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class LibEntry:
    inst: UnitInstance
    mae: float
    mre: float
    mse: float
    wce: float
    area: float
    power: float
    latency: float

    @property
    def feature_vector(self) -> np.ndarray:
        """V = [MSE, Area, Power, Latency] (pruning; Eq. 1-2 of the paper)."""
        return np.array([self.mse, self.area, self.power, self.latency])


@functools.lru_cache(maxsize=None)
def build_library(kind_name: str, count: int | None = None
                  ) -> Tuple[LibEntry, ...]:
    return tuple(LibEntry(inst=inst, **error_metrics(inst), **ppa(inst))
                 for inst in instances(kind_name, count))


def full_library(counts: Dict[str, int] | None = None
                 ) -> Dict[str, Tuple[LibEntry, ...]]:
    counts = counts or TABLE_III
    return {k: build_library(k, n) for k, n in counts.items()}


# --------------------------------------------------------------------------
# batched-labeling exports (LUT truth tables + analytic dispatch metadata)
# --------------------------------------------------------------------------

# Effective (wa, wb) input widths of the stacked LUT tables of the batched
# functional model: only multipliers and sqrt are tabulated, widened past
# the nominal port widths because app dataflows feed wider values (DCT-8's
# column pass streams butterfly sums up to ~13 bits into the mul8x4 port).
# Adders/subtractors are evaluated analytically (units.addsub_batched).
# A runtime guard raises apps.LutDomainError if an app leaves a domain.
LUT_DOMAINS: Dict[str, Tuple[int, int]] = {
    "mul8": (9, 9),        # kmeans |sub10| operands <= 383
    "mul8x4": (13, 4),     # dct8 column-pass butterfly sums <= ~5.2k
    "sqrt18": (20, 0),     # kmeans distance accumulator <= ~4.6e5
}

# Per-app tightening: smaller tables stay in cache.
APP_LUT_DOMAINS: Dict[Tuple[str, str], Tuple[int, int]] = {
    ("gaussian", "mul8x4"): (8, 4),    # taps are raw pixels <= 255
    ("fir15", "mul8x4"): (10, 4),      # pre-adder sums <= 765
}


def lut_domain(app_name: str, kind_name: str) -> Tuple[int, int]:
    return APP_LUT_DOMAINS.get((app_name, kind_name),
                               LUT_DOMAINS[kind_name])


@functools.lru_cache(maxsize=None)
def stacked_lut(entries: Tuple[LibEntry, ...], ea: int, eb: int
                ) -> torch.Tensor:
    """Concatenated truth tables on the CPU, (len(entries) << (ea+eb),)
    int32: entry ``i``'s value for (a, b) sits at ``(i << (ea+eb)) |
    (a << eb) | b``, so folding the per-config library choice into the
    ``a`` operand as ``(i << ea) | a`` turns a batch of mixed
    configurations into one `kernels.ops.lut_eval` gather."""
    return torch.cat([e.inst.lut(ea, eb) for e in entries])


@functools.lru_cache(maxsize=None)
def addsub_dispatch(entries: Tuple[LibEntry, ...]
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(family ids, cut params, seg carry-kill masks) per entry, for
    units.addsub_batched."""
    fam = np.array([FAM_IDS[e.inst.family] for e in entries], np.int32)
    k = np.array([e.inst.param[0] if e.inst.param else 0 for e in entries],
                 np.int32)
    seg = np.array([seg_kill_mask(e.inst.kind.width_a, e.inst.param[0])
                    if e.inst.family == "seg" else 0
                    for e in entries], np.int32)
    return fam, k, seg
