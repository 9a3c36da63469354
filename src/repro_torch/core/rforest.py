"""Minimal random-forest regressor (NumPy CART): the AutoAX baseline.

AutoAX models accelerator PPA and accuracy with random forests over flat
per-unit feature vectors (the accelerator as a black box). The same
deterministic algorithm as `repro.core.rforest`: bagged CART trees,
feature subsampling, variance-reduction splits on quantile thresholds,
with every draw from NumPy's ``default_rng``, so a forest fitted from one
seed on the same arrays has the same trees in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class _Node:
    feature: int = -1
    thresh: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0


class _Tree:
    def __init__(self, max_depth: int, min_leaf: int, n_feat: int,
                 rng: np.random.Generator):
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.n_feat = n_feat
        self.rng = rng
        self.nodes: List[_Node] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "_Tree":
        self._grow(X, y, 0)
        return self

    def _grow(self, X, y, depth) -> int:
        idx = len(self.nodes)
        self.nodes.append(_Node(value=float(y.mean())))
        if depth >= self.max_depth or len(y) < 2 * self.min_leaf or \
                float(y.var()) < 1e-12:
            return idx
        feats = self.rng.choice(X.shape[1], size=min(self.n_feat,
                                                     X.shape[1]),
                                replace=False)
        best = (0.0, -1, 0.0)
        base = y.var() * len(y)
        for f in feats:
            xs = X[:, f]
            qs = np.quantile(xs, (0.25, 0.5, 0.75))
            for t in np.unique(qs):
                m = xs <= t
                nl = int(m.sum())
                if nl < self.min_leaf or len(y) - nl < self.min_leaf:
                    continue
                gain = base - (y[m].var() * nl + y[~m].var() * (len(y) - nl))
                if gain > best[0]:
                    best = (gain, int(f), float(t))
        if best[1] < 0:
            return idx
        _, f, t = best
        m = X[:, f] <= t
        self.nodes[idx].feature = f
        self.nodes[idx].thresh = t
        self.nodes[idx].left = self._grow(X[m], y[m], depth + 1)
        self.nodes[idx].right = self._grow(X[~m], y[~m], depth + 1)
        return idx

    def predict(self, X: np.ndarray) -> np.ndarray:
        out = np.empty(len(X), np.float32)
        for i, row in enumerate(X):
            n = 0
            while self.nodes[n].feature >= 0:
                nd = self.nodes[n]
                n = nd.left if row[nd.feature] <= nd.thresh else nd.right
            out[i] = self.nodes[n].value
        return out


class RandomForest:
    def __init__(self, n_trees: int = 24, max_depth: int = 12,
                 min_leaf: int = 3, feat_frac: float = 0.5, seed: int = 0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.feat_frac = feat_frac
        self.seed = seed
        self.trees: List[_Tree] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForest":
        rng = np.random.default_rng(self.seed)
        n_feat = max(1, int(X.shape[1] * self.feat_frac))
        self.trees = []
        for _ in range(self.n_trees):
            boot = rng.integers(0, len(X), len(X))
            t = _Tree(self.max_depth, self.min_leaf, n_feat,
                      np.random.default_rng(rng.integers(1 << 31)))
            self.trees.append(t.fit(X[boot], y[boot]))
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.mean([t.predict(X) for t in self.trees], axis=0)
