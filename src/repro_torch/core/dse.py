"""Design-space exploration (Sec III-C): NSGA-II, NSGA-III, random, TPE.

The evaluator is pluggable: the GNN surrogate (fast path used by
ApproxPilot), the random-forest baseline (AutoAX), or the synthesis oracle
(ground truth, for validation). Objectives are minimized:
    [area, power, latency, 1 - ssim]
Restart-on-stagnation: if the parent population survives unchanged for
`stagnation` generations, fresh random samples are injected (Sec III-C).

This is the port's own copy of `repro.core.dse` (NumPy only, as there):
every sampler gives the reference's fronts, objective rows and history
bit for bit under a deterministic evaluator (tests/test_torch_search.py).

All samplers route evaluation through `repro_torch.core.engine.SurrogateEngine`
(see `as_engine`): plain callables are wrapped on entry, so every sampler
gets config-key memoization — NSGA's re-evaluations of surviving parents
and restart re-injections are free — plus chunked batching and throughput
stats (`DSEResult.stats`). Pass a pre-built engine to share its cache
across samplers, or a plain deterministic callable to get a private one.

The Pareto hot path (`non_dominated_sort`, `_niche_select`) is fully
broadcasted NumPy: one (n, n) domination matrix instead of the O(n^2)
Python pair loop. The original loop implementations are kept as
`non_dominated_sort_ref` / `_niche_select_ref` and the vectorized versions
are parity-tested against them on randomized instances.

Every sampler records a per-generation convergence trace into
`DSEResult.history`, and all of them accept an ``init`` warm-start
population (e.g. the Pareto front of an earlier run on the same space).
The island-model orchestrator (`repro_torch.core.islands.run_islands`, also
registered as ``SAMPLERS["islands"]``) builds on this module's operators
with persistent per-island populations and ring elite migration.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import (Callable, Dict, Generator, List, Optional, Sequence,
                    Tuple)

import numpy as np

Config = Tuple[int, ...]
EvalFn = Callable[[Sequence[Config]], np.ndarray]   # -> (n, n_obj)
# generation-granular sampler: yields one history dict per generation
# (epoch for islands) and returns the final DSEResult — the serving
# daemon advances these between other requests and streams the yields
StepGen = Generator[Dict, None, "DSEResult"]


@dataclass
class DSEResult:
    """Outcome of one sampler run.

    Attributes:
        pareto_configs: non-dominated configs (objective-deduplicated).
        pareto_objs:    matching (n, n_obj) objective rows.
        evaluated:      evaluations *requested* by the sampler (budget
                        accounting; cache hits inside the engine still
                        count — see ``stats["evaluated"]`` for unique
                        backend evaluations).
        history:        per-generation convergence trace; one dict per
                        generation (or per batch round / island epoch) with
                        keys ``generation``, ``evaluated`` (cumulative
                        requests so far), ``front_size`` (current first
                        non-dominated front), and ``hypervolume``
                        (dominated volume of the current front w.r.t. a
                        reference point fixed at the first generation —
                        comparable across generations of one run).
        stats:          `EngineStats.as_dict()` snapshot from the engine
                        that served this run.
    """
    pareto_configs: List[Config]
    pareto_objs: np.ndarray
    evaluated: int
    history: List[Dict] = field(default_factory=list)
    stats: Optional[Dict] = None


@dataclass
class SearchCheckpoint:
    """Complete, picklable state of a generation-granular sampler at a
    generation (nsga2/nsga3) or epoch (islands) boundary.

    Captures everything the search carries forward — population(s) and
    their objective rows, the evaluated-config archive, the exact RNG
    stream state(s) (`np.random.Generator.bit_generator.state`), the
    convergence history, the budget spent, and the hypervolume reference
    fixed at generation 0 — so a run restarted from a checkpoint replays
    **bit-identically** to the uninterrupted run: same final front, same
    hypervolume trajectory. The engine memo cache is deliberately NOT
    captured: evaluators are deterministic, so a fresh cache re-derives
    identical rows.

    Produced by ``nsga_steps`` / ``islands_steps`` via their
    ``checkpoint_every`` / ``checkpoint_sink`` kwargs (the sink is any
    ``Callable[[SearchCheckpoint], None]``; the pipeline and the serving
    daemon plug in `ArtifactStore.put`, whose atomic write makes torn
    checkpoints impossible) and consumed via ``resume_from``. `meta`
    pins the run parameters (sizes, budget, pop, seed, ...); resuming
    under different parameters raises instead of silently diverging.

    Scalar NSGA fields (``population`` .. ``prev_key``) are None for
    island checkpoints and vice versa (``islands``/``front_X``/
    ``front_F``).
    """
    sampler: str
    generation: int
    evaluated: int
    history: List[Dict]
    hv_ref: np.ndarray
    meta: Dict
    rng_state: Optional[Dict] = None
    population: Optional[np.ndarray] = None
    pop_objs: Optional[np.ndarray] = None
    archive_X: Optional[np.ndarray] = None
    archive_F: Optional[np.ndarray] = None
    stale: int = 0
    prev_key: Optional[tuple] = None
    islands: Optional[List[Dict]] = None
    front_X: Optional[np.ndarray] = None
    front_F: Optional[np.ndarray] = None


def _check_checkpoint(ck: "SearchCheckpoint", meta: Dict) -> None:
    """Refuse to resume a checkpoint under different run parameters —
    silent divergence would break the bit-identity contract."""
    if not isinstance(ck, SearchCheckpoint):
        raise ValueError("resume_from must be a SearchCheckpoint, got "
                         f"{type(ck).__name__}")
    bad = {k: (ck.meta.get(k), v) for k, v in meta.items()
           if ck.meta.get(k) != v}
    if bad:
        raise ValueError(
            "checkpoint does not match this run: " + "; ".join(
                f"{k}: checkpoint={a!r} != run={b!r}"
                for k, (a, b) in sorted(bad.items())))


def as_engine(evaluate: EvalFn) -> "SurrogateEngine":
    """Wrap a plain evaluator in a caching `SurrogateEngine` (idempotent).

    The wrapper assumes `evaluate` is deterministic — true for all three
    ApproxPilot evaluators and the LM-bridge oracle. A stochastic evaluator
    should be pre-wrapped with ``SurrogateEngine(fn, cache=False)``.
    """
    from repro_torch.core.engine import SurrogateEngine
    if isinstance(evaluate, SurrogateEngine):
        return evaluate
    return SurrogateEngine(evaluate, backend="wrapped")


def drain_steps(gen: StepGen) -> "DSEResult":
    """Run a generation-granular sampler generator to completion and
    return its `DSEResult`. ``run_nsga`` et al. are exactly
    ``drain_steps(<sampler>_steps(...))``, so the streamed and one-shot
    paths share every instruction — bit-identical by construction."""
    while True:
        try:
            next(gen)
        except StopIteration as e:
            return e.value


# --------------------------------------------------------------------------
# pareto utilities
# --------------------------------------------------------------------------

def non_dominated_sort(F: np.ndarray) -> List[np.ndarray]:
    """Fast non-dominated sorting of an (n, n_obj) minimization matrix.

    Returns index arrays per front: ``fronts[0]`` is the Pareto set,
    ``fronts[k]`` dominates only fronts > k.

    Vectorized: builds the full (n, n) domination matrix with one
    broadcasted comparison, then peels fronts by decrementing domination
    counts in bulk. Matches `non_dominated_sort_ref` exactly. Intended
    for population-scale inputs (the NSGA selection loop); archive-scale
    callers that only need the first front should use `pareto_mask` /
    `pareto_front`, which run row-blocked in O(block * n) memory.
    """
    F = np.asarray(F)
    n = len(F)
    if n == 0:
        return []
    less = np.all(F[:, None, :] <= F[None, :, :], axis=-1)
    # any(F[i] < F[j]) == not all(F[j] <= F[i]), so the strict test is the
    # transpose of `less` — one broadcast instead of two
    D = less & ~less.T                     # D[i, j]: i dominates j
    dom_count = D.sum(0).astype(np.int64)  # dominators remaining per point
    fronts: List[np.ndarray] = []
    while True:
        current = np.where(dom_count == 0)[0]
        if not len(current):
            break
        fronts.append(current)
        # members of one front never dominate each other, so the bulk
        # decrement only touches strictly later fronts
        dom_count -= D[current].sum(0)
        dom_count[current] = -1            # retire selected points
    return fronts


def non_dominated_sort_ref(F: np.ndarray) -> List[np.ndarray]:
    """Reference O(n^2)-Python-loop implementation of `non_dominated_sort`
    (the pre-vectorization code), kept for parity testing."""
    n = len(F)
    dominated_by = [[] for _ in range(n)]
    dom_count = np.zeros(n, np.int64)
    for i in range(n):
        less = np.all(F[i] <= F, axis=1)
        strict = np.any(F[i] < F, axis=1)
        dominates = less & strict
        dominates[i] = False
        idxs = np.where(dominates)[0]
        for j in idxs:
            dominated_by[i].append(j)
        dom_count += dominates
    fronts = []
    current = np.where(dom_count == 0)[0]
    while len(current):
        fronts.append(current)
        nxt = []
        for i in current:
            for j in dominated_by[i]:
                dom_count[j] -= 1
                if dom_count[j] == 0:
                    nxt.append(j)
        current = np.asarray(sorted(set(nxt)), np.int64)
    return fronts


def non_dominated_ranks(F: np.ndarray) -> np.ndarray:
    """Front index ("rank") per row of an (n, n_obj) minimization matrix:
    rank 0 is the Pareto set, rank k dominates only ranks > k. Equals the
    front index each row gets from `non_dominated_sort` (parity-tested),
    as a flat (n,) array — the layout the batched island fleet consumes.
    """
    F = np.asarray(F)
    if len(F) == 0:
        return np.zeros(0, np.int64)
    return non_dominated_ranks_batched(F[None])[0]


def non_dominated_ranks_batched(F: np.ndarray) -> np.ndarray:
    """`non_dominated_ranks` vectorized over a leading island axis.

    `F` is (n_islands, n, n_obj); returns (n_islands, n) int64 ranks.
    One broadcasted (I, n, n) domination tensor, fronts peeled for all
    islands in lockstep by bulk-decrementing domination counts — the
    per-island results match `non_dominated_sort` exactly. Islands that
    run out of fronts early simply stop contributing to later peels.
    This is the NumPy reference of the island fleet's selection kernel;
    `repro_torch.core.islands.fleet_ranks` adds the PyTorch version on a
    device (bit-identical).
    """
    F = np.asarray(F)
    n_islands, n, _ = F.shape
    less = np.all(F[:, :, None, :] <= F[:, None, :, :], axis=-1)
    # strict test via transpose, as in non_dominated_sort
    D = less & ~np.transpose(less, (0, 2, 1))    # D[b,i,j]: i dominates j
    Di = D.astype(np.int64)
    dom = Di.sum(1)                              # (I, n) dominator counts
    ranks = np.full((n_islands, n), -1, np.int64)
    r = 0
    while True:
        cur = dom == 0
        if not cur.any():
            break
        ranks[cur] = r
        # front members never dominate earlier fronts or each other, so
        # the bulk decrement only touches strictly later fronts
        dom -= np.einsum("bij,bi->bj", Di, cur.astype(np.int64))
        dom[cur] = -1                            # retire ranked points
        r += 1
    return ranks


def crowding_distance(F: np.ndarray) -> np.ndarray:
    """NSGA-II crowding distance per row of F (inf on objective extremes)."""
    n, m = F.shape
    d = np.zeros(n)
    for k in range(m):
        order = np.argsort(F[:, k])
        d[order[0]] = d[order[-1]] = np.inf
        rng = F[order[-1], k] - F[order[0], k] + 1e-12
        d[order[1:-1]] += (F[order[2:], k] - F[order[:-2], k]) / rng
    return d


def pareto_mask(F: np.ndarray) -> np.ndarray:
    """Boolean mask of the first non-dominated front of `F`.

    Sum-sorted compacting cull: a dominator always has a strictly smaller
    objective sum (ties are non-dominating), so sweeping in ascending-sum
    order guarantees the first *surviving* row is always on the front;
    each front member then eliminates its dominated set with one
    vectorized pass over the remaining candidates, which are physically
    compacted so later passes touch only survivors. O(n) memory and
    O(sum of survivor counts) heavy work — on random fronts the first few
    members remove most rows, so this stays near-linear in practice.
    Archive-scale callers with very large n should use
    `pareto_mask_blockwise`.
    """
    F = np.asarray(F)
    n = len(F)
    if n == 0:
        return np.zeros(0, bool)
    order = np.argsort(F.sum(1), kind="stable")
    Fs, ids = F[order], order
    out = np.zeros(n, bool)
    while len(Fs):
        f = Fs[0]
        out[ids[0]] = True
        keep = ~(np.all(Fs >= f, axis=1) & np.any(Fs > f, axis=1))
        keep[0] = False                  # retire the new front member
        Fs, ids = Fs[keep], ids[keep]
    return out


def pareto_mask_blockwise(F: np.ndarray, block: int = 8192) -> np.ndarray:
    """`pareto_mask` for very large archives: divide-and-conquer cull.

    Rows are culled within `block`-sized chunks first, then the union of
    the chunk fronts is culled once more. Exact: any globally dominated
    row is dominated by some global front member (domination is
    transitive), and every global front member survives its chunk cull,
    so the cross-chunk pass over chunk-front survivors reproduces
    `pareto_mask(F)` bit-for-bit.
    """
    F = np.asarray(F)
    n = len(F)
    if n <= block:
        return pareto_mask(F)
    cand = np.concatenate([
        np.arange(i, min(i + block, n))[pareto_mask(F[i:i + block])]
        for i in range(0, n, block)])
    out = np.zeros(n, bool)
    out[cand[pareto_mask(F[cand])]] = True
    return out


# archives larger than this are culled blockwise by `pareto_front`
_BLOCKWISE_MIN = 8192


def pareto_front(configs: Sequence[Config], F: np.ndarray
                 ) -> Tuple[List[Config], np.ndarray]:
    """First non-dominated front of (configs, F), deduplicated on
    (rounded) objective rows. Returns (configs, objectives). Archives
    beyond `_BLOCKWISE_MIN` rows are culled blockwise."""
    if len(F) > _BLOCKWISE_MIN:
        idx = np.where(pareto_mask_blockwise(F))[0]
    else:
        idx = np.where(pareto_mask(F))[0] if len(F) else np.arange(0)
    # dedupe identical objective rows
    seen, keep = set(), []
    for i in idx:
        key = tuple(np.round(F[i], 9))
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return [configs[i] for i in keep], F[keep]


def hypervolume(F: np.ndarray, ref: np.ndarray, n_samples: int = 4096,
                seed: int = 0) -> float:
    """Dominated hypervolume of minimization points `F` w.r.t. `ref`.

    Exact sweep for 2 objectives; deterministic Monte-Carlo estimate for
    >= 3 (fixed-seed samples over the [min(F), ref] box, so values are
    directly comparable across calls that share `ref`). Points beyond
    `ref` are clipped to it, contributing only their in-box volume.
    """
    F = np.asarray(F, np.float64)
    ref = np.asarray(ref, np.float64)
    if not len(F):
        return 0.0
    F = F.reshape(len(F), -1)
    Fc = np.minimum(F, ref)
    lo = Fc.min(0)
    box = np.prod(ref - lo)
    if box <= 0:
        return 0.0
    if F.shape[1] == 2:
        front = Fc[pareto_mask(Fc)]
        order = np.argsort(front[:, 0], kind="stable")
        front = front[order]
        hv, prev1 = 0.0, ref[1]
        for f0, f1 in front:
            if f1 < prev1:
                hv += (ref[0] - f0) * (prev1 - f1)
                prev1 = f1
        return float(hv)
    rng = np.random.default_rng(seed)
    dominated = 0
    remaining = n_samples
    while remaining > 0:
        take = min(remaining, 2048)
        U = lo + rng.random((take, F.shape[1])) * (ref - lo)
        dominated += int(np.any(np.all(Fc[None, :, :] <= U[:, None, :],
                                       axis=-1), axis=1).sum())
        remaining -= take
    return float(box * dominated / n_samples)


def hv_reference(F: np.ndarray, margin: float = 0.05) -> np.ndarray:
    """Canonical hypervolume reference point for an objective matrix:
    componentwise max nudged outward by `margin` (relative to magnitude,
    with an absolute floor so the box never degenerates)."""
    mx = np.asarray(F, np.float64).max(0)
    return mx + np.abs(mx) * margin + 1e-3


# --------------------------------------------------------------------------
# reference points for NSGA-III (Das-Dennis)
# --------------------------------------------------------------------------

def das_dennis(n_obj: int, divisions: int) -> np.ndarray:
    """Das-Dennis simplex-lattice reference directions for NSGA-III:
    all points with coordinates k/divisions summing to 1."""
    pts = []
    for c in itertools.combinations(range(divisions + n_obj - 1),
                                    n_obj - 1):
        prev = -1
        coords = []
        for x in c:
            coords.append(x - prev - 1)
            prev = x
        coords.append(divisions + n_obj - 2 - prev)
        pts.append([v / divisions for v in coords])
    return np.asarray(pts, np.float64)


def _perp_distances(F: np.ndarray, refs: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Normalized perpendicular distance of each point to each Das-Dennis
    reference ray: (d (n, n_refs), nearest-ray index (n,))."""
    ideal = F.min(0)
    span = F.max(0) - ideal + 1e-12
    Fn = (F - ideal) / span
    norm = np.linalg.norm(refs, axis=1, keepdims=True)
    cos = Fn @ refs.T / (np.linalg.norm(Fn, axis=1, keepdims=True) + 1e-12) \
        / norm.T
    d = np.linalg.norm(Fn, axis=1, keepdims=True) * np.sqrt(
        np.maximum(1 - cos ** 2, 0))
    return d, d.argmin(1)


def _niche_select(F: np.ndarray, need: int, refs: np.ndarray,
                  rng: np.random.Generator) -> np.ndarray:
    """NSGA-III niching on the last front (vectorized).

    The distance/association stage is one broadcasted matrix; the greedy
    niche-filling loop works on boolean masks and `np.argmin` instead of
    Python set scans. Semantics match `_niche_select_ref`.
    """
    d, nearest = _perp_distances(F, refs)
    n, n_refs = len(F), len(refs)
    dn = d[np.arange(n), nearest]
    # Pre-sort every point once: primary key nearest ray, secondary its
    # distance to that ray, tertiary index (matches the reference's
    # first-minimum tiebreak). Each ray then owns a contiguous slice and
    # the greedy fill just advances a per-ray pointer — no per-iteration
    # masking/rescans of the whole front.
    order = np.lexsort((np.arange(n), dn, nearest))
    ray_sorted = nearest[order]
    starts = np.searchsorted(ray_sorted, np.arange(n_refs))
    ends = np.searchsorted(ray_sorted, np.arange(n_refs) + 1)
    ptr = starts.copy()
    counts = np.zeros(n_refs, np.int64)
    counts[starts == ends] = 1 << 30            # rays with no members
    chosen: List[int] = []
    while len(chosen) < need:
        r = int(np.argmin(counts))
        if counts[r] >= 1 << 30:                # every ray exhausted
            break
        chosen.append(int(order[ptr[r]]))
        ptr[r] += 1
        counts[r] += 1
        if ptr[r] >= ends[r]:
            counts[r] = 1 << 30
    return np.asarray(chosen, np.int64)


def _niche_select_ref(F: np.ndarray, need: int, refs: np.ndarray,
                      rng: np.random.Generator) -> np.ndarray:
    """Reference Python-loop implementation of `_niche_select` (the
    pre-vectorization code), kept for parity testing."""
    ideal = F.min(0)
    span = F.max(0) - ideal + 1e-12
    Fn = (F - ideal) / span
    norm = np.linalg.norm(refs, axis=1, keepdims=True)
    cos = Fn @ refs.T / (np.linalg.norm(Fn, axis=1, keepdims=True) + 1e-12) \
        / norm.T
    d = np.linalg.norm(Fn, axis=1, keepdims=True) * np.sqrt(
        np.maximum(1 - cos ** 2, 0))
    nearest = d.argmin(1)
    chosen: List[int] = []
    counts = np.zeros(len(refs), np.int64)
    avail = set(range(len(F)))
    while len(chosen) < need and avail:
        r = int(np.argmin(counts))
        members = [i for i in avail if nearest[i] == r]
        if not members:
            counts[r] = 1 << 30
            continue
        pick = min(members, key=lambda i: d[i, r])
        chosen.append(pick)
        avail.discard(pick)
        counts[r] += 1
    return np.asarray(chosen, np.int64)


# --------------------------------------------------------------------------
# genetic operators
# --------------------------------------------------------------------------

def _crossover_mutate(parents: np.ndarray, sizes: Sequence[int],
                      rng: np.random.Generator, p_mut: float = 0.15
                      ) -> np.ndarray:
    n, d = parents.shape
    perm = rng.permutation(n)
    kids = parents[perm].copy()
    for i in range(0, n - 1, 2):
        mask = rng.random(d) < 0.5
        a, b = kids[i].copy(), kids[i + 1].copy()
        kids[i][mask] = b[mask]
        kids[i + 1][mask] = a[mask]
    mut = rng.random(kids.shape) < p_mut
    rand = np.stack([rng.integers(0, s, n) for s in sizes], 1)
    kids[mut] = rand[mut]
    return kids


# --------------------------------------------------------------------------
# samplers
# --------------------------------------------------------------------------

def _clip_init(init: Optional[Sequence[Config]], sizes: Sequence[int],
               limit: int) -> List[Config]:
    """Sanitize a warm-start population: clamp to the space bounds and cap
    its size (migrants may come from a differently-pruned space)."""
    if not init:
        return []
    hi = np.asarray(sizes, np.int64) - 1
    out = [tuple(int(min(max(v, 0), h)) for v, h in zip(c, hi))
           for c in init[:limit]]
    return out


def run_random(sizes: Sequence[int], evaluate: EvalFn, budget: int,
               seed: int = 0, init: Optional[Sequence[Config]] = None
               ) -> DSEResult:
    """Uniform random search baseline (Fig. 6 'random').

    Args:
        sizes:    per-dimension categorical cardinalities (one entry per
                  arithmetic-unit node).
        evaluate: batch evaluator or `SurrogateEngine`; wrapped via
                  `as_engine` so duplicate draws cost nothing.
        budget:   number of configs to sample.
        init:     warm-start configs evaluated first (count against the
                  budget).
    """
    engine = as_engine(evaluate)
    rng = np.random.default_rng(seed)
    configs = _clip_init(init, sizes, budget)
    configs += [tuple(rng.integers(0, s) for s in sizes)
                for _ in range(budget - len(configs))]
    F = engine(configs)
    pc, po = pareto_front(configs, F)
    history = [{"generation": 0, "evaluated": budget, "front_size": len(pc),
                "hypervolume": hypervolume(po, hv_reference(F))}]
    return DSEResult(pc, po, budget, history=history,
                     stats=engine.stats.as_dict())


def tpe_propose(X: Sequence[Config], F: np.ndarray, sizes: Sequence[int],
                n: int, gamma: float, rng: np.random.Generator
                ) -> List[Config]:
    """One TPE proposal step: scalarize the observations, split good/bad
    at the `gamma` quantile, and draw `n` configs per-dimension
    proportional to the smoothed P(dim=v | good) / P(dim=v) ratio.
    Shared by `run_tpe` and the island orchestrator's TPE island."""
    scal = (F / (np.abs(F).max(0) + 1e-12)).sum(1)
    order = np.argsort(scal, kind="stable")
    good = order[:max(2, int(gamma * len(X)))]
    probs = []
    for d, s in enumerate(sizes):
        cnt_g = np.bincount([X[i][d] for i in good], minlength=s) + 0.5
        cnt_a = np.bincount([x[d] for x in X], minlength=s) + 0.5
        p = (cnt_g / cnt_g.sum()) / (cnt_a / cnt_a.sum())
        probs.append(p / p.sum())
    return [tuple(int(rng.choice(s, p=probs[d]))
                  for d, s in enumerate(sizes)) for _ in range(n)]


def run_tpe(sizes: Sequence[int], evaluate: EvalFn, budget: int,
            seed: int = 0, gamma: float = 0.25, batch: int = 64,
            init: Optional[Sequence[Config]] = None) -> DSEResult:
    """Tree-structured-Parzen-lite for categorical spaces (the 'Bayesian'
    sampler of Fig. 6): models P(dim=v | good) vs P(dim=v | bad) on a
    scalarized objective and samples proportional to the ratio.

    Evaluation goes through `as_engine`, so repeated proposals of already
    seen configs are served from the memo cache. `init` configs join the
    first batch, steering the good/bad density model from generation one.
    """
    engine = as_engine(evaluate)
    rng = np.random.default_rng(seed)
    X: List[Config] = _clip_init(init, sizes, min(batch, budget))
    X += [tuple(rng.integers(0, s) for s in sizes)
          for _ in range(min(batch, budget) - len(X))]
    F = engine(X)
    history: List[Dict] = []
    hv_ref = hv_reference(F)

    def record(gen: int) -> None:
        pc, po = pareto_front(X, F)
        history.append({"generation": gen, "evaluated": len(X),
                        "front_size": len(pc),
                        "hypervolume": hypervolume(po, hv_ref)})

    # cap the trace at ~25 entries: each record() scans the cumulative
    # archive, so per-batch recording would turn large budgets superlinear
    rounds_total = max(1, -(-(budget - len(X)) // batch))
    stride = max(1, rounds_total // 24)
    record(0)
    rnd = 0
    while len(X) < budget:
        newc = tpe_propose(X, F, sizes, min(batch, budget - len(X)),
                           gamma, rng)
        Fn = engine(newc)
        X += newc
        F = np.concatenate([F, Fn], 0)
        rnd += 1
        if rnd % stride == 0 or len(X) >= budget:
            record(rnd)
    pc, po = pareto_front(X, F)
    return DSEResult(pc, po, budget, history=history,
                     stats=engine.stats.as_dict())


def nsga_steps(sizes: Sequence[int], evaluate: EvalFn, budget: int,
               seed: int = 0, pop: int = 64, variant: str = "nsga3",
               stagnation: int = 5, ref_divisions: int = 6,
               init: Optional[Sequence[Config]] = None,
               checkpoint_every: int = 0,
               checkpoint_sink: Optional[Callable[["SearchCheckpoint"],
                                                  None]] = None,
               resume_from: Optional["SearchCheckpoint"] = None) -> StepGen:
    """Generation-granular `run_nsga`: yields each `DSEResult.history`
    entry as the generation completes, returns the final result.

    A serving daemon drives this generator so a long DSE request
    yields control between generations — other requests
    interleave, and per-generation Pareto/hypervolume updates stream to
    the client while the search runs. ``run_nsga`` is the one-shot
    wrapper (`drain_steps`), so both paths are the same instructions.

    Crash safety: with ``checkpoint_every=k`` and a ``checkpoint_sink``,
    every k-th completed generation emits a `SearchCheckpoint` (built
    BEFORE the yield, so a consumer killed mid-stream has the state of
    every entry it saw); ``resume_from`` restores one and continues the
    run **bit-identically** to never having stopped — same front, same
    hypervolume trajectory (resume restores the RNG stream state, and
    the deterministic evaluator re-derives any engine-cache rows the
    crash lost). Resuming under different run parameters raises.
    """
    engine = as_engine(evaluate)
    rng = np.random.default_rng(seed)
    meta = {"sampler": variant, "sizes": tuple(int(s) for s in sizes),
            "budget": int(budget), "pop": int(pop), "seed": int(seed),
            "stagnation": int(stagnation),
            "ref_divisions": int(ref_divisions)}

    # incremental archive snapshots: converting the WHOLE tuple archive
    # per checkpoint is O(evaluated) and dominates checkpoint cost at
    # checkpoint_every=1;
    # instead only the rows added since the last checkpoint are converted
    # and appended. The cached arrays are never mutated in place, so
    # handing them to the sink without a copy is safe.
    ck_arch = {"nX": 0, "X": None, "nF": 0, "F": None}

    def _arch_snapshot():
        if ck_arch["nX"] < len(archive_X):
            new = np.asarray(archive_X[ck_arch["nX"]:], np.int64)
            ck_arch["X"] = new if ck_arch["X"] is None else \
                np.concatenate([ck_arch["X"], new], 0)
            ck_arch["nX"] = len(archive_X)
        if ck_arch["nF"] < len(archive_F):
            blocks = archive_F[ck_arch["nF"]:]
            ck_arch["F"] = np.concatenate(
                ([ck_arch["F"]] if ck_arch["F"] is not None else [])
                + list(blocks), 0)
            ck_arch["nF"] = len(archive_F)
        return ck_arch["X"], ck_arch["F"]

    def maybe_checkpoint() -> None:
        if not checkpoint_every or checkpoint_sink is None or \
                (len(history) - 1) % checkpoint_every != 0:
            return
        aX, aF = _arch_snapshot()
        # shallow history snapshot: entries are append-only and never
        # mutated after record(), so copying the list suffices (resume
        # deep-copies on restore)
        checkpoint_sink(SearchCheckpoint(
            sampler=variant, generation=len(history) - 1,
            evaluated=evaluated, history=list(history),
            hv_ref=np.array(hv_ref, np.float64), meta=dict(meta),
            rng_state=rng.bit_generator.state,
            population=np.array(P, np.int64),
            pop_objs=np.array(F, np.float64),
            archive_X=aX, archive_F=aF,
            stale=stale,
            prev_key=(tuple(tuple(int(v) for v in row) for row in prev_key)
                      if prev_key is not None else None)))

    if resume_from is not None:
        ck = resume_from
        _check_checkpoint(ck, meta)
        rng.bit_generator.state = ck.rng_state
        P = np.array(ck.population, np.int64)
        F = np.array(ck.pop_objs, np.float64)
        evaluated = int(ck.evaluated)
        refs = das_dennis(F.shape[1], ref_divisions)
        archive_X = [tuple(int(v) for v in r) for r in ck.archive_X]
        archive_F = [np.array(ck.archive_F, np.float64)]
        stale = int(ck.stale)
        prev_key = ck.prev_key
        history = [dict(h) for h in ck.history]
        hv_ref = np.array(ck.hv_ref, np.float64)
    else:
        P = np.stack([rng.integers(0, s, pop) for s in sizes], 1)
        seeded = _clip_init(init, sizes, pop)
        if seeded:
            P[:len(seeded)] = np.asarray(seeded, np.int64)
        F = engine([tuple(r) for r in P])
        evaluated = pop
        refs = das_dennis(F.shape[1], ref_divisions)
        archive_X = [tuple(r) for r in P]
        archive_F = [F]
        stale = 0
        prev_key = None
        history = []
        hv_ref = hv_reference(F)

    def record(parent_front: np.ndarray) -> None:
        history.append({"generation": len(history), "evaluated": evaluated,
                        "front_size": len(parent_front),
                        "hypervolume": hypervolume(parent_front, hv_ref)})

    if resume_from is None:
        record(F[non_dominated_sort(F)[0]])
        maybe_checkpoint()
        yield history[-1]
    while evaluated < budget:
        Q = _crossover_mutate(P, sizes, rng)
        FQ = engine([tuple(r) for r in Q])
        evaluated += len(Q)
        archive_X += [tuple(r) for r in Q]
        archive_F.append(FQ)
        R = np.concatenate([P, Q], 0)
        FR = np.concatenate([F, FQ], 0)
        fronts = non_dominated_sort(FR)
        chosen: List[int] = []
        for fr in fronts:
            if len(chosen) + len(fr) <= pop:
                chosen += list(fr)
            else:
                need = pop - len(chosen)
                if variant == "nsga2":
                    cd = crowding_distance(FR[fr])
                    order = np.argsort(-cd)
                    chosen += list(fr[order[:need]])
                else:
                    sel = _niche_select(FR[fr], need, refs, rng)
                    chosen += list(fr[sel])
                break
        P = R[np.asarray(chosen)]
        F = FR[np.asarray(chosen)]
        key = tuple(sorted(map(tuple, P)))
        if key == prev_key:
            stale += 1
            if stale >= stagnation:   # restart: inject fresh randoms
                n_new = pop // 2
                P[:n_new] = np.stack(
                    [rng.integers(0, s, n_new) for s in sizes], 1)
                F[:n_new] = engine([tuple(r) for r in P[:n_new]])
                evaluated += n_new
                stale = 0
        else:
            stale = 0
        prev_key = key
        record(F[non_dominated_sort(F)[0]])
        maybe_checkpoint()
        yield history[-1]
    allF = np.concatenate(archive_F, 0)
    pc, po = pareto_front(archive_X, allF)
    return DSEResult(pc, po, evaluated, history=history,
                     stats=engine.stats.as_dict())


def run_nsga(sizes: Sequence[int], evaluate: EvalFn, budget: int,
             seed: int = 0, pop: int = 64, variant: str = "nsga3",
             stagnation: int = 5, ref_divisions: int = 6,
             init: Optional[Sequence[Config]] = None,
             checkpoint_every: int = 0,
             checkpoint_sink: Optional[Callable] = None,
             resume_from: Optional[SearchCheckpoint] = None) -> DSEResult:
    """NSGA-II / NSGA-III with restart-on-stagnation (the paper's DSE).

    Args:
        sizes:         per-dimension categorical cardinalities.
        evaluate:      batch evaluator or `SurrogateEngine` (see
                       `as_engine`); offspring that duplicate earlier
                       individuals hit the engine's memo cache.
        budget:        total evaluation requests before stopping.
        pop:           population size (paper: 64).
        variant:       "nsga2" (crowding distance) or "nsga3" (Das-Dennis
                       niching, the paper's choice for 4 objectives).
        stagnation:    generations of an unchanged parent population before
                       half the population is replaced with fresh randoms.
        ref_divisions: Das-Dennis divisions for the NSGA-III reference set.
        init:          warm-start configs seeded into the initial
                       population (e.g. a previous run's Pareto front);
                       the remainder is filled with uniform randoms.
        checkpoint_every / checkpoint_sink / resume_from:
                       crash safety — see `nsga_steps` /
                       `SearchCheckpoint`.
    """
    return drain_steps(nsga_steps(sizes, evaluate, budget, seed=seed,
                                  pop=pop, variant=variant,
                                  stagnation=stagnation,
                                  ref_divisions=ref_divisions, init=init,
                                  checkpoint_every=checkpoint_every,
                                  checkpoint_sink=checkpoint_sink,
                                  resume_from=resume_from))


def _run_islands(*args, **kwargs) -> DSEResult:
    # lazy import: islands.py builds on this module's samplers
    from repro_torch.core.islands import run_islands
    return run_islands(*args, **kwargs)


def _run_islands_ref(*args, **kwargs) -> DSEResult:
    # the scalar parity oracle, selectable from pipelines/benchmarks
    from repro_torch.core.islands import run_islands_ref
    return run_islands_ref(*args, **kwargs)


SAMPLERS = {"random": run_random, "tpe": run_tpe,
            "nsga2": lambda *a, **k: run_nsga(*a, variant="nsga2", **k),
            "nsga3": lambda *a, **k: run_nsga(*a, variant="nsga3", **k),
            "islands": _run_islands, "islands_ref": _run_islands_ref}


def iter_sampler(sampler: str, sizes: Sequence[int], evaluate: EvalFn,
                 budget: int, seed: int = 0, **kwargs) -> StepGen:
    """Uniform generation-granular interface over every sampler.

    Returns a generator that yields `DSEResult.history` entries as they
    are produced and returns the final `DSEResult` — the yielded dicts
    ARE the entries of the returned ``history`` (same objects, same
    order), which the serving parity tests assert.

    ``nsga2``/``nsga3`` step truly per generation (`nsga_steps`);
    ``islands`` steps per epoch boundary (`islands_steps`). The
    sequential state machines (``tpe``, ``random``, ``islands_ref``) have
    no incremental form — they run to completion on the first advance and
    replay their history, so streaming is post-hoc but the protocol (and
    bit-identity with ``SAMPLERS[name]``) is preserved.

    The stepping samplers also accept the crash-safety kwargs
    ``checkpoint_every=`` / ``checkpoint_sink=`` / ``resume_from=``
    (see `SearchCheckpoint`); the sequential ones cannot checkpoint —
    passing those kwargs for them raises rather than silently running
    without crash safety.
    """
    if sampler in ("nsga2", "nsga3"):
        return nsga_steps(sizes, evaluate, budget, seed=seed,
                          variant=sampler, **kwargs)
    if sampler == "islands":
        from repro_torch.core.islands import islands_steps
        return islands_steps(sizes, evaluate, budget, seed=seed, **kwargs)
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r} "
                         f"(have {sorted(SAMPLERS)})")
    if kwargs.pop("checkpoint_every", 0) or \
            kwargs.pop("checkpoint_sink", None) is not None or \
            kwargs.pop("resume_from", None) is not None:
        raise ValueError(
            f"sampler {sampler!r} runs to completion in one step and "
            "cannot checkpoint or resume (only nsga2/nsga3/islands can)")

    def replay() -> StepGen:
        res = SAMPLERS[sampler](sizes, evaluate, budget, seed=seed,
                                **kwargs)
        for entry in res.history:
            yield entry
        return res

    return replay()
