"""Design-space pruning (Sec III-A): invalid-design + redundant-design.

Invalid  (Eq. 1): remove any candidate dominated on all four dims of
                  V = [MSE, Area, Power, Latency] (all lower-is-better).
Redundant(Eq. 2): K-means in normalized V space; K grown until every
                  cluster's diameter <= theta, then one member kept per
                  cluster (deterministic seed stands in for "random").
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.accel import library as lib


def invalid_prune(entries: Sequence[lib.LibEntry]) -> List[lib.LibEntry]:
    V = np.stack([e.feature_vector for e in entries])
    keep = []
    for i in range(len(entries)):
        dominated = False
        for j in range(len(entries)):
            if i == j:
                continue
            if np.all(V[j] <= V[i]) and np.any(V[j] < V[i]):
                dominated = True
                break
        if not dominated:
            keep.append(entries[i])
    return keep


def _kmeans(X: np.ndarray, k: int, seed: int, iters: int = 50
            ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = X[rng.choice(len(X), size=k, replace=False)]
    assign = np.zeros(len(X), np.int64)
    for _ in range(iters):
        d = ((X[:, None] - centers[None]) ** 2).sum(-1)
        new_assign = d.argmin(-1)
        if np.all(new_assign == assign):
            break
        assign = new_assign
        for c in range(k):
            m = assign == c
            if m.any():
                centers[c] = X[m].mean(0)
    return assign


def redundant_prune(entries: Sequence[lib.LibEntry], theta: float = 0.15,
                    seed: int = 0) -> List[lib.LibEntry]:
    if len(entries) <= 2:
        return list(entries)
    V = np.stack([e.feature_vector for e in entries])
    rho = 1.0 / (V.std(0) + 1e-9)                 # normalization coefficients
    Vn = V * rho
    for k in range(1, len(entries) + 1):
        assign = _kmeans(Vn, k, seed)
        ok = True
        for c in range(k):
            pts = Vn[assign == c]
            if len(pts) > 1:
                diam = np.sqrt(((pts[:, None] - pts[None]) ** 2
                                ).sum(-1)).max()
                if diam > theta * np.sqrt(Vn.shape[1]):
                    ok = False
                    break
        if ok:
            break
    keep = []
    for c in range(k):
        members = [i for i in range(len(entries)) if assign[i] == c]
        # keep the exact unit if present, else the first member
        exact = [i for i in members if entries[i].inst.level == 0]
        keep.append(entries[(exact or members)[0]])
    keep.sort(key=lambda e: (e.inst.level, e.inst.name))
    return keep


def prune_library(counts: Dict[str, int] | None = None, theta: float = 0.15
                  ) -> Tuple[Dict[str, List[lib.LibEntry]], Dict[str, Dict]]:
    """Returns (pruned library, per-kind size report)."""
    full = lib.full_library(counts)
    out, report = {}, {}
    for kind, entries in full.items():
        inv = invalid_prune(entries)
        red = redundant_prune(inv, theta=theta)
        # a functionally exact unit must always stay available (note: it may
        # be an approximate-FAMILY instance like aca_1 whose carry approx
        # happens to be exact — it legitimately dominates the ripple adder)
        if not any(e.mse == 0 for e in red):
            red.insert(0, entries[0])
        out[kind] = red
        report[kind] = {"initial": len(entries), "after_invalid": len(inv),
                        "after_redundant": len(red)}
    return out, report


def space_sizes(app, report_or_lib) -> Dict[str, float]:
    """Design-space cardinality for an accelerator at each pruning stage."""
    sizes = {"initial": 1.0, "after_invalid": 1.0, "after_redundant": 1.0}
    for n in app.unit_nodes:
        if isinstance(next(iter(report_or_lib.values())), dict):
            rep = report_or_lib[n.kind]
            for k in sizes:
                sizes[k] *= rep[k]
        else:
            sizes["after_redundant"] *= len(report_or_lib[n.kind])
    return sizes
