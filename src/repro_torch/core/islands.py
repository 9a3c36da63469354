"""Island-model parallel DSE as ONE batched array program.

The paper's search layer (Sec III-C) is a single serial NSGA-III
population. Once surrogate evaluation is batched and memoized
(`repro_torch.core.engine.SurrogateEngine`), the sampler itself becomes
the
bottleneck — and a single population also converges to one basin of the
4-objective landscape. The island fleet scales the search layer:

  * **N islands** — by default a homogeneous cone-partitioned ``nsga3``
    fleet (each island niches inside a distinct Das-Dennis reference
    cone; the merge restores full front coverage) with per-island seeds
    derived from ``(seed, island)``;
  * **one stacked state** — populations live as an ``(n_islands, pop,
    n_units)`` integer array and objective rows as ``(n_islands, pop,
    n_obj)``; selection runs on batched non-domination ranks
    (`fleet_ranks`: NumPy, or integer-rank front peeling in PyTorch on a
    device), crossover/mutation arithmetic is one
    ``(n_islands, pop, n_units)`` tensor step — no threads, no
    per-island Python evolution loops;
  * **one fused evaluation** per generation: every island's proposals go
    through the shared `SurrogateEngine` as a single
    ``(n_islands*pop, n_units)`` block, so cross-island rediscoveries
    are cache hits and the engine stats aggregate the whole search;
  * **elite broadcast migration** (default) — at each epoch boundary all
    islands receive the top-``migrate_k`` scalarized members of the
    *merged* Pareto front, objective rows attached: migration never
    re-spends budget. Classic ``migration="ring"`` (right-neighbour
    elites) is kept as an option;
  * **merged global archive** — the final front is the non-dominated set
    over every config any island evaluated (blockwise Pareto cull for
    large archives), and `DSEResult.history` traces the merged front's
    size/hypervolume per epoch.

Unlike naively running the `dse` samplers in rounds, islands
evolve *continuously*: populations persist across epochs (no warm-start
re-evaluation, no re-randomization), so at equal request budget the
islands spend exactly as much fresh search as the serial samplers.

Determinism and parity: the scalar per-island orchestrator is kept as
`run_islands_ref` — the oracle the batched program is tested against.
Both consume identical per-island RNG streams, so their merged fronts
and hypervolume trajectories are IDENTICAL; the PyTorch rank peeling
works on exact integer ranks, so results are also bit-identical across
backends and devices. This is the port's own copy of
`repro.core.islands`: fronts, rows and history equal the reference's bit
for bit under a deterministic evaluator (tests/test_torch_search.py).
With ``devices=`` the "torch" ranking splits the island axis over the
devices (`distributed.meshes.shard_leading_axis`), each slice peeled on
its own device, with the same ranks. Fleets containing the
sequential ``tpe``/``random`` state machines fall back to the scalar
path (same results, schedule-independent).

Exposed as `run_islands(...)`, as ``dse.SAMPLERS["islands"]`` (the
scalar oracle as ``SAMPLERS["islands_ref"]``), and as
``PipelineConfig(sampler="islands")``.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core.dse import (Config, DSEResult, EvalFn,
                                  SearchCheckpoint, StepGen,
                                  _check_checkpoint, _crossover_mutate,
                                  _niche_select, as_engine,
                                  crowding_distance, das_dennis,
                                  drain_steps, hv_reference, hypervolume,
                                  non_dominated_ranks_batched,
                                  non_dominated_sort, pareto_front,
                                  tpe_propose)

# the classic mixed fleet (island i runs DEFAULT_SAMPLERS[i % 4]); pass as
# `samplers=` explicitly — the default fleet is homogeneous nsga3 cones,
# which dominated the mixed fleet on merged hypervolume at equal budget
# in the reference's measurements
DEFAULT_SAMPLERS: Tuple[str, ...] = ("nsga3", "nsga2", "tpe", "random")
NDS_BACKENDS = ("auto", "numpy", "torch")


@dataclass
class IslandConfig:
    """Knobs of the island fleet. `run_islands`
    and `run_islands_ref` mirror these defaults.

    Attributes:
        n_islands:  number of concurrently-evolving islands.
        samplers:   per-island sampler names, cycled when shorter than
                    ``n_islands``; each of "nsga3" | "nsga2" | "tpe" |
                    "random". ``None`` (default) means a homogeneous
                    ``("nsga3",) * n_islands`` fleet — with
                    ``partition_refs`` this is cone-separated parallel
                    NSGA-III, the strongest configuration the
                    reference measured. Fleets containing "tpe"/"random"
                    run on the scalar path.
        epochs:     migration rounds: the generation budget is split into
                    this many epochs, with migration (and a history
                    entry) at each epoch boundary.
        migrate_k:  elites injected per epoch. Keep this small (1-4) and
                    the epochs few: migrating often homogenizes the
                    islands and forfeits the diversity the model exists
                    for (measured: epoch-frequency sweeps lose 6-9% hv).
        pop:        per-island population size (equals the per-generation
                    evaluation batch of every island kind).
        partition_refs: when several ``nsga3`` islands run, give each a
                    distinct cone of the Das-Dennis reference rays
                    (argmax-objective partition) — cone-separated parallel
                    NSGA-III. Inert for the mixed fleet (one nsga3
                    island).
        migration:  "broadcast" (default) — every island receives the
                    top-``migrate_k`` scalarized members of the merged
                    front; "ring" — each island sends its own archive
                    elites to its right-hand neighbour (a no-op with one
                    island).
        nds_backend: batched non-domination ranking backend for the
                    batched path: "numpy", "torch" (integer-rank front
                    peeling on a device, bit-identical to numpy), or
                    "auto" (torch iff more than one device is given
                    or more than one CUDA device is visible).
        parallel:   `run_islands_ref` only — step the scalar islands of
                    one generation in a thread pool (results are
                    schedule-independent).
    """
    n_islands: int = 4
    samplers: Optional[Sequence[str]] = None
    epochs: int = 4
    migrate_k: int = 4
    pop: int = 16
    partition_refs: bool = True
    migration: str = "broadcast"
    nds_backend: str = "auto"
    parallel: bool = True


def _island_seed(seed: int, island: int) -> int:
    """Deterministic per-island seed, decorrelated from `seed`."""
    return int(np.random.SeedSequence([seed, island]).generate_state(1)[0])


def _scalarize(F: np.ndarray) -> np.ndarray:
    return (F / (np.abs(F).max(0) + 1e-12)).sum(1)


# --------------------------------------------------------------------------
# island state machines
# --------------------------------------------------------------------------

class _Island:
    """One persistent sampler population.

    Protocol per generation: ``propose()`` returns the configs to
    evaluate, ``ingest(F)`` feeds back their objective rows. Both the
    proposals and every migrant received via ``receive(X, F)`` accumulate
    into the island archive (`arch_X` / `arch_F`).
    """

    def __init__(self, name: str, sizes: Sequence[int], pop: int,
                 seed: int):
        self.name = name
        self.sizes = list(sizes)
        self.pop = pop
        self.rng = np.random.default_rng(seed)
        self.arch_X: List[Config] = []
        self.arch_F: List[np.ndarray] = []
        self._seen = set()

    # -- archive ------------------------------------------------------------

    def _archive(self, X: Sequence[Config], F: np.ndarray) -> None:
        self.arch_X += list(X)
        self.arch_F.append(np.asarray(F, np.float64))
        self._seen.update(tuple(int(v) for v in c) for c in X)

    def _freshen(self, Q: np.ndarray, tries: int = 8) -> np.ndarray:
        """Duplicate-avoiding proposals: nudge rows the island has already
        archived (random-coordinate walk, bounded tries) so budget is not
        spent re-requesting known points. A key island-level edge: the
        serial samplers spend ~30% of their requests on cache hits."""
        batch = set()
        for k in range(len(Q)):
            key = tuple(int(v) for v in Q[k])
            t = 0
            while (key in self._seen or key in batch) and t < tries:
                d = int(self.rng.integers(0, len(self.sizes)))
                Q[k, d] = self.rng.integers(0, self.sizes[d])
                key = tuple(int(v) for v in Q[k])
                t += 1
            batch.add(key)
        return Q

    def archive(self) -> Tuple[List[Config], np.ndarray]:
        return self.arch_X, (np.concatenate(self.arch_F, 0)
                             if self.arch_F else np.zeros((0, 1)))

    def elites(self, k: int) -> Tuple[List[Config], np.ndarray]:
        """Up to k archive-front members, best scalarized first
        (deterministic: ties broken by archive order)."""
        X, F = self.archive()
        if not X:
            return [], np.zeros((0, 1))
        pc, po = pareto_front(X, F)
        order = np.argsort(_scalarize(po), kind="stable")[:k]
        return [pc[i] for i in order], po[order]

    def _randoms(self, n: int) -> np.ndarray:
        return np.stack([self.rng.integers(0, s, n) for s in self.sizes], 1)

    # -- generation protocol -------------------------------------------------

    def propose(self) -> List[Config]:
        raise NotImplementedError

    def ingest(self, F: np.ndarray) -> None:
        raise NotImplementedError

    def receive(self, X: Sequence[Config], F: np.ndarray) -> None:
        """Accept migrants (objective rows attached — costs no budget)."""
        if not len(X):
            return
        self._archive(X, F)


class _RandomIsland(_Island):
    """Uniform exploration; its only job is feeding fresh genetic material
    into the ring."""

    def propose(self) -> List[Config]:
        self._Q = self._freshen(self._randoms(self.pop))
        return [tuple(r) for r in self._Q]

    def ingest(self, F: np.ndarray) -> None:
        self._archive([tuple(r) for r in self._Q], F)


class _TpeIsland(_Island):
    """Tree-structured-Parzen-lite (see `dse.run_tpe`) over a persistent
    observation archive; migrants sharpen its good/bad density model."""

    def __init__(self, name, sizes, pop, seed, gamma: float = 0.25):
        super().__init__(name, sizes, pop, seed)
        self.gamma = gamma

    def propose(self) -> List[Config]:
        X, F = self.archive()
        if len(X) < 2 * len(self.sizes):
            self._Q = [tuple(r) for r in self._freshen(self._randoms(
                self.pop))]
            return self._Q
        Q = np.asarray(tpe_propose(X, F, self.sizes, self.pop, self.gamma,
                                   self.rng), np.int64)
        self._Q = [tuple(r) for r in self._freshen(Q)]
        return self._Q

    def ingest(self, F: np.ndarray) -> None:
        self._archive(self._Q, F)


class _NsgaIsland(_Island):
    """NSGA-II/III population identical to one `dse.run_nsga` lineage,
    reshaped into the generation protocol; migrants replace its
    worst-scalarized members without re-evaluation."""

    def __init__(self, name, sizes, pop, seed, variant: str,
                 ref_divisions: int = 6):
        super().__init__(name, sizes, pop, seed)
        self.variant = variant
        self.ref_divisions = ref_divisions
        self.cone: Optional[int] = None    # objective index, set by the
        self.P: Optional[np.ndarray] = None  # orchestrator (cone separation)
        self.F: Optional[np.ndarray] = None
        self.refs: Optional[np.ndarray] = None

    def propose(self) -> List[Config]:
        if self.P is None:
            self._Q = self._randoms(self.pop)      # initial population
        else:
            self._Q = self._freshen(
                _crossover_mutate(self.P, self.sizes, self.rng))
        return [tuple(r) for r in self._Q]

    def ingest(self, FQ: np.ndarray) -> None:
        self._archive([tuple(r) for r in self._Q], FQ)
        if self.P is None:
            self.P, self.F = self._Q, np.asarray(FQ, np.float64)
            self.refs = das_dennis(self.F.shape[1], self.ref_divisions)
            if self.cone is not None:
                # cone separation: keep only the reference rays leaning
                # toward this island's objective, so its niching digs deep
                # in one region of the front while the merge restores
                # full coverage
                part = self.refs[self.refs.argmax(1)
                                 == self.cone % self.refs.shape[1]]
                if len(part) >= 2:
                    self.refs = part
            return
        R = np.concatenate([self.P, self._Q], 0)
        FR = np.concatenate([self.F, FQ], 0)
        fronts = non_dominated_sort(FR)
        chosen: List[int] = []
        for fr in fronts:
            if len(chosen) + len(fr) <= self.pop:
                chosen += list(fr)
            else:
                need = self.pop - len(chosen)
                if self.variant == "nsga2":
                    order = np.argsort(-crowding_distance(FR[fr]))
                    chosen += list(fr[order[:need]])
                else:
                    sel = _niche_select(FR[fr], need, self.refs, self.rng)
                    chosen += list(fr[sel])
                break
        idx = np.asarray(chosen)
        self.P, self.F = R[idx], FR[idx]

    def receive(self, X: Sequence[Config], F: np.ndarray) -> None:
        super().receive(X, F)
        if self.P is None or not len(X):
            return
        # splice migrants over the worst-scalarized residents (skip exact
        # duplicates so migration adds information, not copies)
        resident = {tuple(r) for r in self.P}
        fresh = [(c, f) for c, f in zip(X, F) if tuple(c) not in resident]
        if not fresh:
            return
        worst = np.argsort(_scalarize(self.F), kind="stable")[::-1]
        for (c, f), j in zip(fresh, worst):
            self.P[j] = np.asarray(c, self.P.dtype)
            self.F[j] = f


def _make_island(name: str, sizes: Sequence[int], pop: int, seed: int
                 ) -> _Island:
    if name in ("nsga2", "nsga3"):
        return _NsgaIsland(name, sizes, pop, seed, variant=name)
    if name == "tpe":
        return _TpeIsland(name, sizes, pop, seed)
    if name == "random":
        return _RandomIsland(name, sizes, pop, seed)
    raise ValueError(f"unknown island sampler {name!r}")


# --------------------------------------------------------------------------
# batched fleet kernels
# --------------------------------------------------------------------------

def _dense_ranks(F: np.ndarray) -> np.ndarray:
    """Per-column dense integer ranks of an (I, n, m) objective stack.

    ``a[j] <= b[j]`` iff ``rank(a[j]) <= rank(b[j])`` (np.unique sorts
    ascending and gives tied values the same rank), so Pareto domination
    over the int32 ranks is EXACTLY domination over the floats. This lets
    the device kernel run in integer arithmetic: no float64->float32
    truncation and bit-identical fronts on any backend or device.
    """
    n_islands, n, m = F.shape
    R = np.empty((n_islands, n, m), np.int32)
    for b in range(n_islands):
        for j in range(m):
            R[b, :, j] = np.unique(F[b, :, j], return_inverse=True)[1]
    return R


def _peel(slices: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Batched front peeling of (I_k, n, m) int32 rank tensors, each on
    its own device, in lockstep: each round is issued on every slice
    before the one read of whether any slice still has members left. A
    slice whose members are all ranked goes through the later rounds
    unchanged, so each slice's ranks are those it would get alone."""
    state = []
    for R in slices:
        less = (R[:, :, None, :] <= R[:, None, :, :]).all(-1)
        D = (less & ~less.transpose(1, 2)).to(torch.int32)   # i dominates j
        state.append([D, D.sum(1), torch.full(
            R.shape[:2], -1, dtype=torch.int64, device=R.device)])
    r = 0
    while True:
        curs = [dom == 0 for _, dom, _ in state]
        if not any([bool(c.any()) for c in curs]):
            break
        for st, cur in zip(state, curs):
            D, dom, ranks = st
            st[2] = torch.where(cur, r, ranks)
            # integer products have no CUDA matmul: a masked sum instead
            dec = (D * cur[:, :, None]).sum(1)
            st[1] = torch.where(cur, -1, dom - dec)
        r += 1
    return [ranks for _, _, ranks in state]


def _ranks_kernel_torch(R: np.ndarray, devs: Sequence[torch.device]
                       ) -> np.ndarray:
    """Batched front peeling over an (I, n, m) int32 rank tensor: the
    reference's `_ranks_kernel_jax` loop in PyTorch, its island axis
    split over ``devs`` (`meshes.shard_leading_axis`, axis "island"; the
    whole tensor on ``devs[0]`` when no prefix of them divides it). Each
    slice is peeled on its device and the ranks are gathered in island
    order. Every op is island-local, and the arithmetic is integer, so the
    result equals `dse.non_dominated_ranks_batched` exactly."""
    from repro_torch.distributed import meshes
    Rt = torch.from_numpy(np.ascontiguousarray(R, np.int32))
    sh = meshes.shard_leading_axis(Rt, len(R), axis_name="island",
                                   devices=devs)
    slices = sh.shards if isinstance(sh, meshes.Sharded) \
        else [Rt.to(devs[0])]
    return torch.cat([r.cpu() for r in _peel(slices)]).numpy()


def _listed(devices) -> int:
    """The length of an explicit device sequence (0 for a count)."""
    if devices is None or isinstance(devices, (int, str)):
        return 0
    return len(devices)


def fleet_ranks(F: np.ndarray, backend: str = "auto", device=None,
                devices=None) -> np.ndarray:
    """Non-domination rank of every member of every island.

    (I, n, m) objectives -> (I, n) int64 ranks, equal per island to the
    front index assigned by `dse.non_dominated_sort`.

    backend:
      * "numpy" — `dse.non_dominated_ranks_batched`;
      * "torch" — integer-rank front peeling on ``device`` (default: the
                  CUDA card), bit-identical to numpy (`_dense_ranks`);
                  with ``devices`` (a count or a sequence of devices,
                  `device.device_list`) the island axis is split over
                  them;
      * "auto"  — "torch" iff more than one device is given or more than
                  one CUDA device is visible, where the reference picks
                  its JAX kernel, else "numpy".
    """
    F = np.asarray(F, np.float64)
    if backend not in NDS_BACKENDS:
        raise ValueError(f"unknown nds_backend {backend!r}")
    if backend == "auto":
        backend = ("torch" if _listed(devices) > 1
                   or torch.cuda.device_count() > 1 else "numpy")
    if backend == "numpy":
        return non_dominated_ranks_batched(F)
    return _ranks_kernel_torch(_dense_ranks(F),
                               device_lib.device_list(devices, device))


def _crossover_mutate_fleet(P: np.ndarray, sizes: Sequence[int],
                            rngs: Sequence[np.random.Generator],
                            p_mut: float = 0.15) -> np.ndarray:
    """`dse._crossover_mutate` over a whole (I, pop, d) fleet at once.

    RNG draws stay per-island in the reference call order (permutation,
    per-pair swap masks, mutation matrix, per-dimension resample values),
    so every island consumes exactly the stream it would consume under
    `run_islands_ref`; only the swap/mutate arithmetic is batched over
    the island axis.
    """
    n_islands, n, d = P.shape
    n_pairs = len(range(0, n - 1, 2))
    perms = np.stack([rng.permutation(n) for rng in rngs])
    masks = (np.stack([rng.random((n_pairs, d)) for rng in rngs])
             if n_pairs else np.zeros((n_islands, 0, d)))
    mut = np.stack([rng.random((n, d)) for rng in rngs])
    rand = np.stack([np.stack([rng.integers(0, s, n) for s in sizes], 1)
                     for rng in rngs])
    kids = P[np.arange(n_islands)[:, None], perms]
    if n_pairs:
        pairs = kids[:, :2 * n_pairs].reshape(n_islands, n_pairs, 2, d)
        swap = (masks < 0.5)[:, :, None, :]
        kids[:, :2 * n_pairs] = np.where(
            swap, pairs[:, :, ::-1, :], pairs).reshape(
                n_islands, 2 * n_pairs, d)
    return np.where(mut < p_mut, rand, kids)


def _select_from_ranks(ranks: np.ndarray, FR: np.ndarray, pop: int,
                       isl: _NsgaIsland) -> np.ndarray:
    """Environmental selection from precomputed non-domination ranks;
    front-by-front fill plus niche/crowding on the cut front, exactly as
    `_NsgaIsland.ingest` does from `non_dominated_sort` fronts."""
    chosen: List[int] = []
    for r in range(int(ranks.max()) + 1):
        fr = np.where(ranks == r)[0]
        if len(chosen) + len(fr) <= pop:
            chosen += list(fr)
        else:
            need = pop - len(chosen)
            if isl.variant == "nsga2":
                order = np.argsort(-crowding_distance(FR[fr]))
                chosen += list(fr[order[:need]])
            else:
                sel = _niche_select(FR[fr], need, isl.refs, isl.rng)
                chosen += list(fr[sel])
            break
    return np.asarray(chosen)


# --------------------------------------------------------------------------
# orchestrators
# --------------------------------------------------------------------------

def _check_migration(migration: str) -> None:
    if migration not in ("broadcast", "ring"):
        raise ValueError(f"unknown migration {migration!r}")


def _build_fleet(sizes, seed, n_islands, samplers, pop, partition_refs):
    if n_islands < 1:
        raise ValueError("n_islands must be >= 1")
    names = [samplers[i % len(samplers)] for i in range(n_islands)]
    islands = [_make_island(names[i], sizes, pop, _island_seed(seed, i))
               for i in range(n_islands)]
    nsga3_islands = [isl for isl in islands
                     if isinstance(isl, _NsgaIsland)
                     and isl.variant == "nsga3"]
    if partition_refs and len(nsga3_islands) >= 2:
        for c, isl in enumerate(nsga3_islands):
            isl.cone = c
    return names, islands


def _schedule(budget, n_islands, pop, epochs):
    per_gen = n_islands * pop
    total_gens = max(1, -(-budget // per_gen))     # ceil: spend the budget
    n_epochs = max(1, min(epochs, total_gens))
    return total_gens, {round((e + 1) * total_gens / n_epochs)
                        for e in range(n_epochs)}


def _epoch_boundary(islands, names, migration, migrate_k, hv_ref, gen,
                    evaluated, history):
    """Shared epoch-boundary step of both orchestrators: merge the island
    archives into the global front, migrate elites, append the history
    entry. Returns (pc, po, hv_ref); `hv_ref` is fixed at the first
    boundary so the per-epoch hypervolumes are comparable.

    Migration moves (config, objective-row) pairs — it never re-spends
    budget — and consumes no island RNG, so it cannot desynchronize the
    batched/scalar random streams. Migrants are drawn from archives
    already inside the merged set, so the returned merged front is the
    same whether it is computed before or after the receives.
    """
    allX: List[Config] = []
    allF: List[np.ndarray] = []
    for isl in islands:
        ax, af = isl.archive()
        allX += ax
        allF.append(af)
    F = np.concatenate(allF, 0)
    if hv_ref is None:
        hv_ref = hv_reference(F)
    pc, po = pareto_front(allX, F)
    if migrate_k > 0:
        if migration == "broadcast":
            # global elite broadcast: every island receives the
            # top-migrate_k scalarized members of the MERGED front
            # (stronger than ring-neighbour elites on the library-proxy
            # spaces in the reference's measurements).
            sl = np.argsort(_scalarize(po), kind="stable")[:migrate_k]
            mx, mf = [pc[j] for j in sl], po[sl]
            for isl in islands:
                isl.receive(mx, mf)
        elif len(islands) > 1:
            # ring: i sends its own archive elites to (i+1) mod N; with a
            # single island the self-send is skipped (pure no-op)
            outbox = [isl.elites(migrate_k) for isl in islands]
            for i, (mx, mf) in enumerate(outbox):
                islands[(i + 1) % len(islands)].receive(mx, mf)
    per_island = {}
    for i, isl in enumerate(islands):
        ax, af = isl.archive()
        per_island[f"{i}:{names[i]}"] = len(pareto_front(ax, af)[0])
    history.append({"generation": gen, "evaluated": evaluated,
                    "front_size": len(pc),
                    "hypervolume": hypervolume(po, hv_ref),
                    "islands": per_island})
    return pc, po, hv_ref


def run_islands_ref(sizes: Sequence[int], evaluate: EvalFn, budget: int,
                    seed: int = 0, *, n_islands: int = 4,
                    samplers: Optional[Sequence[str]] = None,
                    epochs: int = 4, migrate_k: int = 4, pop: int = 16,
                    parallel: bool = True, partition_refs: bool = True,
                    migration: str = "broadcast") -> DSEResult:
    """Scalar island orchestrator: per-island state machines stepped one
    generation at a time (optionally in a thread pool — results are
    schedule-independent because islands only interact at the epoch
    barrier).

    This is the PARITY ORACLE for the batched `run_islands`: same
    algorithm, same per-island RNG streams, same merged front and
    hypervolume trajectory.
    It is also the execution path for fleets containing the sequential
    ``tpe``/``random`` samplers.
    """
    _check_migration(migration)
    samplers = tuple(samplers) if samplers else ("nsga3",) * n_islands
    names, islands = _build_fleet(sizes, seed, n_islands, samplers, pop,
                                  partition_refs)
    engine = as_engine(evaluate)
    total_gens, boundaries = _schedule(budget, n_islands, pop, epochs)

    history: List[Dict] = []
    evaluated = 0
    hv_ref: Optional[np.ndarray] = None
    pc: List[Config] = []
    po = np.zeros((0, 1))

    def step(isl: _Island) -> int:
        X = isl.propose()
        isl.ingest(engine(X))
        return len(X)

    pool = (ThreadPoolExecutor(max_workers=n_islands)
            if parallel and n_islands > 1 else None)
    try:
        for gen in range(1, total_gens + 1):
            if pool is not None:
                evaluated += sum(pool.map(step, islands))
            else:
                evaluated += sum(step(isl) for isl in islands)
            if gen in boundaries:
                pc, po, hv_ref = _epoch_boundary(
                    islands, names, migration, migrate_k, hv_ref, gen,
                    evaluated, history)
    finally:
        if pool is not None:
            pool.shutdown()

    # the final generation is always an epoch boundary, so (pc, po) is the
    # merged global front over every island archive
    return DSEResult(pc, po, evaluated, history=history,
                     stats=engine.stats.as_dict())


def islands_steps(sizes: Sequence[int], evaluate: EvalFn, budget: int,
                  seed: int = 0, *, n_islands: int = 4,
                  samplers: Optional[Sequence[str]] = None, epochs: int = 4,
                  migrate_k: int = 4, pop: int = 16,
                  partition_refs: bool = True, migration: str = "broadcast",
                  nds_backend: str = "auto", checkpoint_every: int = 0,
                  checkpoint_sink=None,
                  resume_from: Optional[SearchCheckpoint] = None,
                  device=None, devices=None) -> StepGen:
    """Epoch-granular `run_islands`: yields each epoch-boundary
    `DSEResult.history` entry (merged front size, hypervolume, per-island
    fronts) as it is produced and returns the final result — the serving
    daemon drives this generator so one DSE request never monopolizes the
    scheduler between epochs, and Pareto/hypervolume updates stream to
    the client. ``run_islands`` is the one-shot `drain_steps` wrapper.
    Fleets containing the sequential ``tpe``/``random`` samplers run to
    completion on the first advance (`run_islands_ref`) and replay their
    per-epoch history — identical results, post-hoc streaming.

    Per generation the whole fleet advances as tensors: crossover/
    mutation on the ``(n_islands, pop, n_units)`` population stack
    (`_crossover_mutate_fleet`), ONE fused `SurrogateEngine` call on the
    ``(n_islands*pop, n_units)`` proposal block, batched non-domination
    ranking (`fleet_ranks` — NumPy, or the PyTorch peeling on ``device``),
    then per-island niche/crowding on the small cut
    fronts. Elite migration happens at epoch boundaries only
    (`_epoch_boundary`). No threads, no per-island Python evolution loop.

    Args:
        sizes:     per-dimension categorical cardinalities.
        evaluate:  batch evaluator or `SurrogateEngine`; wrapped via
                   `as_engine` and shared by every island.
        budget:    total evaluation requests across all islands (same
                   accounting as the serial samplers: every proposed
                   config counts, engine cache hits included).
        seed:      master seed; island seeds derive from (seed, island).
        n_islands / samplers / epochs / migrate_k / pop / partition_refs
        / migration / nds_backend:
                   see `IslandConfig`.
        checkpoint_every / checkpoint_sink / resume_from:
                   crash safety (see `dse.SearchCheckpoint`):
                   every ``checkpoint_every``-th epoch boundary emits the
                   fleet state — per-island populations, archives, RNG
                   stream states, cones and reference rays, plus the
                   merged front and history — through ``checkpoint_sink``
                   just after migration; ``resume_from`` restores it and
                   continues **bit-identically** to an uninterrupted run.
                   Only all-NSGA fleets checkpoint (the sequential
                   fallback path has no incremental form — passing these
                   kwargs for it raises). ``nds_backend`` is free to
                   change across a resume: both backends are
                   bit-identical.
        device:    where the "torch" ranking runs (default: the CUDA
                   card).
        devices:   split the "torch" ranking's island axis over these
                   devices (`fleet_ranks`).

    Returns:
        `DSEResult` whose front is the merged global archive's
        non-dominated set and whose ``history`` has one entry per epoch
        (merged front size + hypervolume under an epoch-0-fixed reference,
        plus per-island front sizes).
    """
    _check_migration(migration)
    if nds_backend not in NDS_BACKENDS:
        raise ValueError(f"unknown nds_backend {nds_backend!r}")
    samplers = tuple(samplers) if samplers else ("nsga3",) * n_islands
    names, islands = _build_fleet(sizes, seed, n_islands, samplers, pop,
                                  partition_refs)
    if any(not isinstance(isl, _NsgaIsland) for isl in islands):
        if checkpoint_every or checkpoint_sink is not None \
                or resume_from is not None:
            raise ValueError(
                f"island fleet {tuple(names)} contains sequential "
                "samplers and runs on the one-shot run_islands_ref path, "
                "which cannot checkpoint or resume (use an all-nsga2/"
                "nsga3 fleet for crash safety)")
        res = run_islands_ref(
            sizes, evaluate, budget, seed, n_islands=n_islands,
            samplers=samplers, epochs=epochs, migrate_k=migrate_k,
            pop=pop, parallel=False, partition_refs=partition_refs,
            migration=migration)
        for entry in res.history:
            yield entry
        return res
    engine = as_engine(evaluate)
    total_gens, boundaries = _schedule(budget, n_islands, pop, epochs)
    d = len(sizes)
    # nds_backend and device deliberately excluded: the backends are
    # bit-identical, so a resume may switch backends freely
    meta = {"sampler": "islands", "sizes": tuple(int(s) for s in sizes),
            "budget": int(budget), "seed": int(seed),
            "n_islands": int(n_islands), "samplers": tuple(names),
            "epochs": int(epochs), "migrate_k": int(migrate_k),
            "pop": int(pop), "partition_refs": bool(partition_refs),
            "migration": migration}

    # incremental per-island archive snapshots: converting every island's
    # whole tuple archive per checkpoint is O(evaluated); only the rows
    # added since the last checkpoint are converted and appended (gated
    # (the reference gates the overhead at 5%). The cached arrays are
    # never mutated in place, so the sink gets them without a copy.
    ck_arch: Dict[int, Dict] = {}

    def _arch_snapshot(i: int, isl):
        c = ck_arch.setdefault(i, {"nX": 0, "X": None, "nF": 0, "F": None})
        if c["nX"] < len(isl.arch_X):
            new = np.asarray(isl.arch_X[c["nX"]:], np.int64)
            c["X"] = new if c["X"] is None else \
                np.concatenate([c["X"], new], 0)
            c["nX"] = len(isl.arch_X)
        if c["nF"] < len(isl.arch_F):
            c["F"] = np.concatenate(
                ([c["F"]] if c["F"] is not None else [])
                + list(isl.arch_F[c["nF"]:]), 0)
            c["nF"] = len(isl.arch_F)
        return c["X"], c["F"]

    def _island_state(i: int, isl) -> Dict:
        aX, aF = _arch_snapshot(i, isl)
        return {"name": isl.name,
                "rng_state": isl.rng.bit_generator.state,
                "P": np.array(isl.P, np.int64),
                "F": np.array(isl.F, np.float64),
                "arch_X": aX, "arch_F": aF,
                "cone": isl.cone,
                "refs": np.array(isl.refs, np.float64)}

    def maybe_checkpoint(gen: int) -> None:
        if not checkpoint_every or checkpoint_sink is None or \
                len(history) % checkpoint_every != 0:
            return
        # shallow history snapshot: entries are append-only, never
        # mutated after record (resume deep-copies on restore)
        checkpoint_sink(SearchCheckpoint(
            sampler="islands", generation=gen, evaluated=evaluated,
            history=list(history),
            hv_ref=np.array(hv_ref, np.float64), meta=dict(meta),
            islands=[_island_state(i, isl)
                     for i, isl in enumerate(islands)],
            front_X=np.asarray(pc, np.int64).reshape(len(pc), d),
            front_F=np.array(po, np.float64)))

    if resume_from is not None:
        ck = resume_from
        _check_checkpoint(ck, meta)
        for isl, st in zip(islands, ck.islands):
            isl.rng.bit_generator.state = st["rng_state"]
            isl.P = np.array(st["P"], np.int64)
            isl.F = np.array(st["F"], np.float64)
            isl.arch_X = [tuple(int(v) for v in r) for r in st["arch_X"]]
            isl.arch_F = [np.array(st["arch_F"], np.float64)]
            isl._seen = set(isl.arch_X)
            isl.cone = st["cone"]
            isl.refs = np.array(st["refs"], np.float64)
        history = [dict(h) for h in ck.history]
        evaluated = int(ck.evaluated)
        hv_ref = np.array(ck.hv_ref, np.float64)
        pc = [tuple(int(v) for v in r) for r in ck.front_X]
        po = np.array(ck.front_F, np.float64)
        start_gen = int(ck.generation)
    else:
        history = []
        evaluated = 0
        hv_ref = None
        pc = []
        po = np.zeros((0, 1))
        start_gen = 0

    for gen in range(start_gen + 1, total_gens + 1):
        first = islands[0].P is None
        if first:
            # generation 1 proposes raw randoms (no freshen), like the
            # scalar _NsgaIsland.propose
            Q = np.stack([isl._randoms(pop) for isl in islands])
        else:
            P = np.stack([isl.P for isl in islands])
            kids = _crossover_mutate_fleet(
                P, sizes, [isl.rng for isl in islands])
            Q = np.stack([isl._freshen(kids[i])
                          for i, isl in enumerate(islands)])
        # ONE fused evaluation for the whole fleet; the engine memo makes
        # this value-identical to per-island calls
        FQ = np.asarray(
            engine([tuple(r) for r in Q.reshape(-1, d)]),
            np.float64).reshape(n_islands, pop, -1)
        evaluated += n_islands * pop
        if first:
            for i, isl in enumerate(islands):
                isl._Q = Q[i]
                isl.ingest(FQ[i])      # init path: sets P/F/refs + cone
        else:
            for i, isl in enumerate(islands):
                isl._archive([tuple(r) for r in Q[i]], FQ[i])
            R = np.concatenate([P, Q], 1)
            FR = np.concatenate(
                [np.stack([isl.F for isl in islands]), FQ], 1)
            ranks = fleet_ranks(FR, backend=nds_backend, device=device,
                                devices=devices)
            for i, isl in enumerate(islands):
                idx = _select_from_ranks(ranks[i], FR[i], pop, isl)
                isl.P, isl.F = R[i][idx], FR[i][idx]
        if gen in boundaries:
            pc, po, hv_ref = _epoch_boundary(
                islands, names, migration, migrate_k, hv_ref, gen,
                evaluated, history)
            maybe_checkpoint(gen)
            yield history[-1]

    # the final generation is always an epoch boundary, so (pc, po) is the
    # merged global front over every island archive
    return DSEResult(pc, po, evaluated, history=history,
                     stats=engine.stats.as_dict())


def run_islands(sizes: Sequence[int], evaluate: EvalFn, budget: int,
                seed: int = 0, *, n_islands: int = 4,
                samplers: Optional[Sequence[str]] = None, epochs: int = 4,
                migrate_k: int = 4, pop: int = 16,
                partition_refs: bool = True, migration: str = "broadcast",
                nds_backend: str = "auto", checkpoint_every: int = 0,
                checkpoint_sink=None,
                resume_from: Optional[SearchCheckpoint] = None,
                device=None, devices=None) -> DSEResult:
    """Run the island-model DSE as one batched array program; drop-in
    alternative to the serial samplers (one-shot wrapper over
    `islands_steps` — see that generator for the streaming form).

    Args:
        sizes:     per-dimension categorical cardinalities.
        evaluate:  batch evaluator or `SurrogateEngine`; wrapped via
                   `as_engine` and shared by every island.
        budget:    total evaluation requests across all islands (same
                   accounting as the serial samplers: every proposed
                   config counts, engine cache hits included).
        seed:      master seed; island seeds derive from (seed, island).
        n_islands / samplers / epochs / migrate_k / pop / partition_refs
        / migration / nds_backend:
                   see `IslandConfig`.
        device:    where the "torch" ranking runs (default: the CUDA
                   card).
        devices:   split the "torch" ranking's island axis over these
                   devices (`fleet_ranks`).

    Returns:
        `DSEResult` whose front is the merged global archive's
        non-dominated set and whose ``history`` has one entry per epoch
        (merged front size + hypervolume under an epoch-0-fixed reference,
        plus per-island front sizes).
    """
    return drain_steps(islands_steps(
        sizes, evaluate, budget, seed, n_islands=n_islands,
        samplers=samplers, epochs=epochs, migrate_k=migrate_k, pop=pop,
        partition_refs=partition_refs, migration=migration,
        nds_backend=nds_backend, checkpoint_every=checkpoint_every,
        checkpoint_sink=checkpoint_sink, resume_from=resume_from,
        device=device, devices=devices))


def library_proxy_evaluator(app, entries: Dict[str, Sequence]) -> EvalFn:
    """Cheap vectorized analytic evaluator over an accelerator's pruned
    library: [area, power, latency, 1 - exp(-sum mre)] per config.

    Area/power are the synthesis oracle's sums (fixed components folded
    into a constant); **latency is the oracle's true longest-path delay**
    (node latency + fanout wire delay, maximized over all source→sink
    paths of the broken-back-edge DAG), computed as a (batch, paths)
    matmul against a precomputed path-incidence matrix. Only the oracle's
    deterministic jitter and the SSIM functional model are dropped, so the
    landscape keeps the critical-path plateau structure of the real
    problem. ~Free per config: search-layer tests measure the sampler
    rather than the surrogate.
    """
    import networkx as nx

    from repro_torch.accel.synth import (FIXED_PPA, LEAKAGE_FRAC,
                                         acyclic_dataflow, wire_delay)

    unit_ids = [n.id for n in app.unit_nodes]
    uidx = {nid: j for j, nid in enumerate(unit_ids)}
    tables = [np.asarray([[e.area, e.power, e.latency, e.mre]
                          for e in entries[node.kind]], np.float64)
              for node in app.unit_nodes]
    fixed = {n.id: n for n in app.nodes if n.fixed}
    area0 = sum(FIXED_PPA[n.kind]["area"] for n in fixed.values())
    power0 = sum(FIXED_PPA[n.kind]["power"] for n in fixed.values())

    g = acyclic_dataflow(app)          # synth's DAG, shared code path
    srcs = [n for n in g.nodes if g.in_degree(n) == 0]
    snks = [n for n in g.nodes if g.out_degree(n) == 0]
    inc_rows, consts = [], []
    for s in srcs:
        for t in snks:
            for path in nx.all_simple_paths(g, s, t):
                row = np.zeros(len(unit_ids))
                const = 0.0
                for nid in path:
                    const += wire_delay(g, nid)
                    if nid in fixed:
                        const += FIXED_PPA[fixed[nid].kind]["latency"]
                    else:
                        row[uidx[nid]] = 1.0
                inc_rows.append(row)
                consts.append(const)
    inc = np.asarray(inc_rows)                      # (paths, units)
    consts = np.asarray(consts)

    def evaluate(configs: Sequence[Config]) -> np.ndarray:
        C = np.asarray(configs, np.int64)
        rows = np.stack([t[C[:, j]] for j, t in enumerate(tables)], 1)
        area = rows[..., 0].sum(1) + area0
        power = (rows[..., 1].sum(1) + power0) * (1 + LEAKAGE_FRAC)
        latency = (rows[..., 2] @ inc.T + consts).max(1)
        err = 1.0 - np.exp(-rows[..., 3].sum(1))
        return np.stack([area, power, latency, err], 1)

    return evaluate
