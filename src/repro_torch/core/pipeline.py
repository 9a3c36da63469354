"""ApproxPilot end-to-end pipeline (Fig. 1), as composable cached stages:

   prune -> dataset -> train -> engine -> search -> validate

The port's copy of `repro.core.pipeline`. Each stage is a function over
typed artifacts, keyed into a content-addressed
`repro_torch.core.artifacts.ArtifactStore` by a stable hash of exactly
the config slice that governs it: a second run, a DSE sweep over
``dse_budget``/``sampler``, or `validate_pareto` reuses the cached
dataset, parameters and engine. `run()` is a thin wrapper over
`run_staged` with a store of its own.

`surrogate="rf"` swaps in the AutoAX random-forest baseline and
`surrogate="oracle"` the synthesis oracle; all three reach the search
through `repro_torch.core.engine.SurrogateEngine`, whose counters land
in ``PipelineResult.metrics["engine"]``. The search is pluggable via
``sampler``: the samplers of `repro_torch.core.dse` or the island fleet
(`sampler="islands"`); per-generation traces land in
``PipelineResult.metrics["dse_history"]``. `unified_surrogate` trains one
cross-app two-stage GNN over the merged datasets of several accelerators
and serves a `SurrogateEngine.from_gnn_shared` view per app.

Devices. `run_staged`, `run`, `validate_pareto` and `unified_surrogate`
take ``device=``: with none they run on the CUDA card (`gnn_mp` in every
GNN layer, `lut_eval` in labeling and the featurizer's probe), and with no
card they raise (`repro_torch.device.resolve`); ``device="cpu"`` runs the
plain PyTorch path. Disk-tier artifacts are device-independent (the
dataset, `TrainArtifact` with NumPy parameters, `DSEResult`), and their
keys do not name a device; the memory-only artifacts bound to a device
(the app context's tensors, the engine) carry the resolved device in
their keys, so a CPU run and a card run sharing a store never swap them.

The reference's ``use_kernel`` field has no counterpart: in the port the
tensor's device decides between the CUDA kernels and the plain path, so
it is absent from `PipelineConfig` and from the engine's key.
``eval_devices`` is the engine's ``devices=``: the reference's count (``1``
no split, ``0`` every local device of the run's type, ``N`` at most N)
or a tuple of device names, which may name one device several times;
the engine splits each chunk's config rows over them with the same rows.
Like the reference, the engine's key leaves it out.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import device as device_lib
from repro_torch.accel import apps as apps_lib
from repro_torch.core import dataset as ds_lib
from repro_torch.core import dse, gnn, models, pruning, training
from repro_torch.core import graph as graph_lib
from repro_torch.core.artifacts import ArtifactStore
from repro_torch.core.engine import SurrogateEngine
from repro_torch.core.rforest import RandomForest
from repro_torch.data import images as images_lib

OBJ_NAMES = ("area", "power", "latency", "1-ssim")


@dataclass
class PipelineConfig:
    app: str = "sobel"
    n_samples: int = 1500
    theta: float = 0.15
    gnn_arch: str = "gsae"
    hidden: int = 96
    n_layers: int = 3
    epochs: int = 30
    dse_budget: int = 2000
    dse_pop: int = 64
    sampler: str = "nsga3"          # nsga3 | nsga2 | tpe | random |
                                    # islands | islands_ref
    dse_islands: int = 4            # island count for sampler="islands"
    dse_migrate_k: int = 4          # merged-front elites broadcast per epoch
    seed: int = 0
    use_critical_path: bool = True
    surrogate: str = "gnn"          # gnn | rf | oracle
    eval_chunk: int = 512           # engine chunk size for the DSE loop
    eval_devices: Union[int, Tuple[str, ...]] = 1  # devices the engine
                                    # splits its chunks over (0 = all of
                                    # the device's type, or device names)
    eval_overlap: bool = True       # overlap host featurization with
                                    # device compute on multi-chunk waves
    ensemble_members: int = 0       # >0: GNN ensemble + uncertainty
    ensemble_archs: Optional[Tuple[str, ...]] = None  # per-member archs
    early_stop_patience: int = 0    # >0: early stopping on a val split
    train_backend: str = "scan"     # scan | loop (one training loop)
    artifact_dir: Optional[str] = None  # on-disk artifact cache root
    dse_checkpoint_every: int = 0   # >0: checkpoint the search every N
                                    # generations into the store; a rerun
                                    # of the same config resumes from the
                                    # last checkpoint (nsga2/nsga3/islands)

    @staticmethod
    def paper_faithful(app: str) -> "PipelineConfig":
        n = {"sobel": 55_000, "gaussian": 105_000, "kmeans": 105_000,
             "dct8": 105_000, "fir15": 105_000}[app]
        return PipelineConfig(app=app, n_samples=n, hidden=300, n_layers=5,
                              epochs=100, dse_budget=20_000)


# --------------------------------------------------------------------------
# typed stage artifacts
# --------------------------------------------------------------------------

@dataclass
class AppContext:
    """Shared app setup: the pruned library entries of the app's unit
    kinds, the pruning report and space sizes, and the functional model's
    ground truth (the 4x64x64 image set and the exact design's output) on
    one device."""
    app_name: str
    app: apps_lib.AccelDef
    entries: Dict[str, Sequence]
    report: Dict[str, Dict]
    space: Dict[str, float]
    inp: torch.Tensor
    exact_out: torch.Tensor


@dataclass
class TrainArtifact:
    """Output of the train stage, one of three surrogate families;
    parameters as NumPy."""
    two_cfg: models.TwoStageConfig
    metrics: Dict[str, Dict]
    params: Optional[models.TwoStageParams] = None
    ens: Optional[training.EnsembleParams] = None
    rf_models: Dict[int, RandomForest] = field(default_factory=dict)


@dataclass
class PipelineResult:
    cfg: PipelineConfig
    pruned_sizes: Dict[str, Dict]
    space: Dict[str, float]
    metrics: Dict[str, Dict]     # per-target quality + "engine" throughput
    pareto_configs: List[Tuple[int, ...]]
    pareto_objs: np.ndarray
    timings: Dict[str, float]
    dataset: object
    engine: SurrogateEngine      # the surrogate engine used for DSE

    @property
    def predictor(self) -> SurrogateEngine:
        """Deprecated alias for ``engine``."""
        return self.engine


# --------------------------------------------------------------------------
# cache-key specs: exactly the config slice each stage depends on
# --------------------------------------------------------------------------

def _prune_spec(cfg: PipelineConfig) -> Dict:
    return {"app": cfg.app, "theta": cfg.theta}


def _dataset_spec(cfg: PipelineConfig) -> Dict:
    # the feature schema re-keys the dataset and everything downstream
    return {**_prune_spec(cfg), "n_samples": cfg.n_samples,
            "seed": cfg.seed,
            "feature_schema": graph_lib.ACTIVE_SCHEMA.version}


def _train_spec(cfg: PipelineConfig) -> Dict:
    return {"dataset": _dataset_spec(cfg), "surrogate": cfg.surrogate,
            "gnn_arch": cfg.gnn_arch, "hidden": cfg.hidden,
            "n_layers": cfg.n_layers, "epochs": cfg.epochs,
            "seed": cfg.seed, "use_critical_path": cfg.use_critical_path,
            "ensemble_members": cfg.ensemble_members,
            "ensemble_archs": cfg.ensemble_archs,
            "early_stop_patience": cfg.early_stop_patience,
            "train_backend": cfg.train_backend}


def _engine_spec(cfg: PipelineConfig) -> Dict:
    # eval_devices and eval_overlap are left out, as dse_checkpoint_every
    # is from the search spec: they do not change the rows
    return {"train": _train_spec(cfg), "eval_chunk": cfg.eval_chunk}


def _search_spec(cfg: PipelineConfig) -> Dict:
    return {"engine": _engine_spec(cfg), "sampler": cfg.sampler,
            "dse_budget": cfg.dse_budget, "dse_pop": cfg.dse_pop,
            "dse_islands": cfg.dse_islands,
            "dse_migrate_k": cfg.dse_migrate_k, "seed": cfg.seed}


def _on(spec: Dict, dev: torch.device) -> Dict:
    """A memory-only artifact's spec, bound to its device."""
    return {**spec, "device": str(dev)}


def default_store(cfg: PipelineConfig) -> ArtifactStore:
    """Store for one run: on disk at ``cfg.artifact_dir`` when set,
    otherwise in-process memory only."""
    return ArtifactStore(cfg.artifact_dir)


# --------------------------------------------------------------------------
# shared app context (used by the stages and validate_pareto)
# --------------------------------------------------------------------------

def app_context(app_name: str, theta: float = 0.15,
                store: Optional[ArtifactStore] = None, device=None
                ) -> AppContext:
    """Pruned library -> app entries -> image set -> exact output, on
    ``device`` (default: the CUDA card). Memory-cached per (app, theta,
    device) when a store is given."""
    dev = device_lib.resolve(device)

    def build() -> AppContext:
        app = apps_lib.APPS[app_name]
        pruned, report = pruning.prune_library(theta=theta)
        entries = {k: pruned[k] for k in {n.kind for n in app.unit_nodes}}
        space = pruning.space_sizes(app, report)
        inp = apps_lib.app_inputs(app_name, images_lib.image_set(4, 64),
                                  dev)
        exact_out = app.run(
            apps_lib.make_impls(app, apps_lib.exact_choice(app)), inp)
        return AppContext(app_name, app, entries, report, space, inp,
                          exact_out)

    if store is None:
        return build()
    key = store.key("prune", _on({"app": app_name, "theta": theta}, dev))
    return store.get_or_build("prune", key, build, memory_only=True)


# --------------------------------------------------------------------------
# stages
# --------------------------------------------------------------------------

def stage_prune(cfg: PipelineConfig, store: ArtifactStore, device=None
                ) -> AppContext:
    """Design-space pruning + app ground-truth context (Sec III-A)."""
    return app_context(cfg.app, cfg.theta, store, device=device)


def stage_dataset(cfg: PipelineConfig, store: ArtifactStore,
                  ctx: AppContext, device=None) -> ds_lib.AccelDataset:
    """Labeled dataset over the pruned space (Sec III-B1), labeled on
    ``device``; disk-cached."""
    dev = device_lib.resolve(device)
    key = store.key("dataset", _dataset_spec(cfg))
    return store.get_or_build("dataset", key, lambda: ds_lib.build(
        cfg.app, n_samples=cfg.n_samples, seed=cfg.seed,
        lib_entries=ctx.entries, device=dev))


def _np_params(params):
    """Tensor leaves -> NumPy, so trained params pickle
    device-independently."""
    return None if params is None else pytree.tree_map(
        lambda t: t.detach().cpu().numpy(), params)


def _np_ens(ens: Optional[training.EnsembleParams]):
    if ens is None:
        return None
    return training.EnsembleParams(
        groups=[(c, _np_params(p)) for c, p in ens.groups],
        member_arch=list(ens.member_arch))


def stage_train(cfg: PipelineConfig, store: ArtifactStore,
                ds: ds_lib.AccelDataset, verbose: bool = False,
                device=None) -> TrainArtifact:
    """Surrogate fitting (two-stage GNN / ensemble / RF baseline) on
    ``device``; disk-cached. ``surrogate="oracle"`` is a no-op artifact."""
    dev = device_lib.resolve(device)
    two_cfg = models.TwoStageConfig(
        gnn=gnn.GNNConfig(arch=cfg.gnn_arch, n_layers=cfg.n_layers,
                          hidden=cfg.hidden,
                          feature_dim=ds.x.shape[-1]),
        use_critical_path=cfg.use_critical_path,
        schema_version=getattr(ds, "schema_version", 1))

    def build() -> TrainArtifact:
        tr, te = ds.split(0.9)
        if cfg.surrogate == "gnn":
            tc = training.TrainConfig(epochs=cfg.epochs, seed=cfg.seed,
                                      backend=cfg.train_backend,
                                      patience=cfg.early_stop_patience)
            if cfg.ensemble_members > 0:
                ens, _hist = training.fit_ensemble(
                    two_cfg, tr, tc, n_members=cfg.ensemble_members,
                    archs=cfg.ensemble_archs, device=dev)
                metrics = training.evaluate_ensemble(ens, ds, te,
                                                     device=dev)
                return TrainArtifact(two_cfg, metrics, ens=_np_ens(ens))
            params = training.fit_two_stage(
                two_cfg, tr, tc, log_every=0 if not verbose else 10,
                device=dev)
            metrics = training.evaluate(two_cfg, params, ds, te,
                                        device=dev)
            return TrainArtifact(two_cfg, metrics,
                                 params=_np_params(params))
        if cfg.surrogate == "rf":
            Xf_tr, Xf_te = tr.flat_features(), te.flat_features()
            rf_models: Dict[int, RandomForest] = {}
            metrics = {}
            for i, tname in enumerate(models.TARGETS):
                rf = RandomForest(seed=cfg.seed + i).fit(Xf_tr, tr.y[:, i])
                rf_models[i] = rf
                pred = rf.predict(Xf_te) * ds.y_std[i] + ds.y_mean[i]
                metrics[tname] = {
                    "r2": training.r2_score(te.y_raw[:, i], pred),
                    "mape": training.mape(te.y_raw[:, i], pred)}
            return TrainArtifact(two_cfg, metrics, rf_models=rf_models)
        return TrainArtifact(two_cfg, {})      # oracle: nothing to fit

    key = store.key("train", _train_spec(cfg))
    return store.get_or_build("train", key, build)


def _eval_devices(cfg: PipelineConfig, dev: torch.device
                  ) -> List[torch.device]:
    """The devices of ``cfg.eval_devices`` for an engine on ``dev``
    (`device.device_list`: 0 reads as every device of ``dev``'s type)."""
    return device_lib.device_list(cfg.eval_devices, dev)


def stage_engine(cfg: PipelineConfig, store: ArtifactStore,
                 ctx: AppContext, ds: ds_lib.AccelDataset,
                 art: TrainArtifact, device=None) -> SurrogateEngine:
    """Surrogate-evaluation engine for the DSE loop on ``device``;
    memory-cached under a key that names the device. The engine rebuilds
    the disk-cached NumPy parameters on its device."""
    dev = device_lib.resolve(device)
    devices = _eval_devices(cfg, dev)

    def build() -> SurrogateEngine:
        if cfg.surrogate == "oracle":
            return SurrogateEngine.from_oracle(ctx.app, ctx.entries,
                                               ctx.inp, ctx.exact_out)
        if cfg.surrogate == "rf":
            return SurrogateEngine.from_rforest(art.rf_models, ds, ctx.app,
                                                ctx.entries, device=dev)
        if art.ens is not None:
            ens = training.EnsembleParams(
                groups=[(c, models.params_from_numpy(p, dev))
                        for c, p in art.ens.groups],
                member_arch=list(art.ens.member_arch))
            return SurrogateEngine.from_gnn_ensemble(
                ens, ds, ctx.app, ctx.entries, chunk_size=cfg.eval_chunk,
                devices=devices, overlap=cfg.eval_overlap, device=dev)
        return SurrogateEngine.from_gnn(
            art.two_cfg, models.params_from_numpy(art.params, dev), ds,
            ctx.app, ctx.entries, chunk_size=cfg.eval_chunk,
            devices=devices, overlap=cfg.eval_overlap, device=dev)

    key = store.key("engine", _on(_engine_spec(cfg), dev))
    return store.get_or_build("engine", key, build, memory_only=True)


def stage_search(cfg: PipelineConfig, store: ArtifactStore,
                 ctx: AppContext, engine: SurrogateEngine) -> dse.DSEResult:
    """NSGA-III / island DSE over the engine (Sec III-C); disk-cached.

    With ``cfg.dse_checkpoint_every > 0`` and a generational sampler
    (nsga2/nsga3/islands), the running search puts a
    `dse.SearchCheckpoint` into the store every N generations under a
    ``search_ckpt`` key; a rerun of the same config resumes from the last
    checkpoint and gives the front and history the uninterrupted run
    would have, bit for bit. The checkpoint is evicted once the result is
    cached. The knob is not in the search key: checkpointed and plain
    runs give the same result and share one slot."""
    ck_key = store.key("search_ckpt", _search_spec(cfg))
    can_ckpt = (cfg.dse_checkpoint_every > 0
                and cfg.sampler in ("nsga2", "nsga3", "islands"))

    def ckpt_kwargs() -> Dict:
        if not can_ckpt:
            return {}
        kw: Dict = {"checkpoint_every": cfg.dse_checkpoint_every,
                    "checkpoint_sink": lambda ck: store.put(ck_key, ck)}
        try:
            kw["resume_from"] = store.get(ck_key)
        except KeyError:
            pass
        return kw

    def build() -> dse.DSEResult:
        sizes = [len(ctx.entries[n.kind]) for n in ctx.app.unit_nodes]
        sampler = dse.SAMPLERS[cfg.sampler]
        if cfg.sampler in ("islands", "islands_ref"):
            # dse_pop is the global population; islands split it evenly
            res = sampler(sizes, engine, cfg.dse_budget, seed=cfg.seed,
                          n_islands=cfg.dse_islands,
                          migrate_k=cfg.dse_migrate_k,
                          pop=max(2, cfg.dse_pop // cfg.dse_islands),
                          **ckpt_kwargs())
        elif cfg.sampler.startswith("nsga"):
            res = sampler(sizes, engine, cfg.dse_budget, seed=cfg.seed,
                          pop=cfg.dse_pop, **ckpt_kwargs())
        else:
            res = sampler(sizes, engine, cfg.dse_budget, seed=cfg.seed)
        if can_ckpt:
            store.evict(ck_key)      # finished: the result key takes over
        return res

    key = store.key("search", _search_spec(cfg))
    return store.get_or_build("search", key, build)


# --------------------------------------------------------------------------
# orchestration: the staged path and the one-call wrapper
# --------------------------------------------------------------------------

def run_staged(cfg: PipelineConfig, store: Optional[ArtifactStore] = None,
               verbose: bool = False, device=None) -> PipelineResult:
    """Execute the stage graph against an artifact store on ``device``
    (default: the CUDA card).

    Pass a shared ``store`` to reuse datasets, parameters and engines
    across runs and sweeps; with ``store=None`` a fresh store is made per
    call (memory-only unless ``cfg.artifact_dir`` is set)."""
    dev = device_lib.resolve(device)
    store = store if store is not None else default_store(cfg)
    t: Dict[str, float] = {}
    # snapshot, so metrics["store"] reports this run's hits and misses
    hits0 = dict(store.stats.hits)
    miss0 = dict(store.stats.misses)

    t0 = time.time()
    ctx = stage_prune(cfg, store, device=dev)
    t["prune"] = time.time() - t0

    t0 = time.time()
    ds = stage_dataset(cfg, store, ctx, device=dev)
    t["dataset"] = time.time() - t0

    t0 = time.time()
    art = stage_train(cfg, store, ds, verbose=verbose, device=dev)
    t["train"] = time.time() - t0

    engine = stage_engine(cfg, store, ctx, ds, art, device=dev)

    t0 = time.time()
    res = stage_search(cfg, store, ctx, engine)
    t["dse"] = time.time() - t0

    metrics = dict(art.metrics)
    metrics["engine"] = {"backend": engine.backend,
                         **engine.stats.as_dict()}
    metrics["dse_history"] = res.history
    metrics["store"] = {
        "hits": {k: v - hits0.get(k, 0)
                 for k, v in store.stats.hits.items()
                 if v - hits0.get(k, 0)},
        "misses": {k: v - miss0.get(k, 0)
                   for k, v in store.stats.misses.items()
                   if v - miss0.get(k, 0)}}
    if art.ens is not None and res.pareto_configs:
        # the ensemble std on the selected points, from the engine's memo
        unc = engine.uncertainty(res.pareto_configs)
        metrics["pareto_uncertainty"] = {
            n: float(unc[:, i].mean()) for i, n in enumerate(OBJ_NAMES)}

    return PipelineResult(cfg, ctx.report, ctx.space, metrics,
                          res.pareto_configs, res.pareto_objs, t, ds,
                          engine)


def run(cfg: PipelineConfig, verbose: bool = False, device=None
        ) -> PipelineResult:
    """One-call entry point: `run_staged` with a store of its own."""
    return run_staged(cfg, store=None, verbose=verbose, device=device)


def _oracle_eval(app, entries, inp, exact_out):
    """Ground-truth evaluator on the batched labeling path (vectorized
    synthesis oracle + the config-batched functional model on ``inp``'s
    device)."""
    from repro_torch.accel import batch_oracle

    def evaluate(configs: Sequence[Tuple[int, ...]]) -> np.ndarray:
        return batch_oracle.objective_rows(app, entries, configs, inp,
                                           exact_out)
    return evaluate


def validate_pareto(result: PipelineResult, k: int = 10,
                    store: Optional[ArtifactStore] = None, device=None
                    ) -> Dict[str, float]:
    """Oracle-check k Pareto points on ``device`` (default: the CUDA
    card): the surrogate's relative error on the selected designs. Pass
    the run's store to reuse its app context."""
    cfg = result.cfg
    ctx = app_context(cfg.app, cfg.theta, store, device=device)
    oracle = _oracle_eval(ctx.app, ctx.entries, ctx.inp, ctx.exact_out)
    sel = result.pareto_configs[:k]
    if not sel:
        return {"mean_rel_err": float("nan")}
    true = oracle(sel)
    pred = result.pareto_objs[:len(sel)]
    rel = np.abs(pred - true) / np.maximum(np.abs(true), 1e-6)
    return {"mean_rel_err": float(rel.mean()),
            "per_obj": {n: float(rel[:, i].mean())
                        for i, n in enumerate(OBJ_NAMES)}}


# --------------------------------------------------------------------------
# cross-app unified surrogate
# --------------------------------------------------------------------------

@dataclass
class UnifiedResult:
    """One shared two-stage GNN over several apps + per-app engine views."""
    two_cfg: models.TwoStageConfig
    params: models.TwoStageParams
    merged: ds_lib.MergedDataset
    metrics: Dict[str, Dict]               # union test split + per_app
    engines: Dict[str, SurrogateEngine]    # per-app views, shared params
    timings: Dict[str, float]


def unified_surrogate(apps: Sequence[str], cfg: PipelineConfig,
                      store: Optional[ArtifactStore] = None,
                      split: float = 0.9, device=None) -> UnifiedResult:
    """Train (or reuse) one cross-app surrogate and its per-app engines
    on ``device`` (default: the CUDA card).

    Runs the cached prune and dataset stages per app, merges them
    (`dataset.merge`), fits one shared two-stage GNN over the union
    (disk-cached against the app set and the train slice), and serves
    each app through `SurrogateEngine.from_gnn_shared`."""
    if len(apps) < 1:
        raise ValueError("unified_surrogate needs at least one app")
    if cfg.surrogate != "gnn" or cfg.ensemble_members > 0:
        raise ValueError(
            "unified_surrogate fits one shared two-stage GNN; "
            f"surrogate={cfg.surrogate!r} / ensemble_members="
            f"{cfg.ensemble_members} are not supported here")
    dev = device_lib.resolve(device)
    store = store if store is not None else default_store(cfg)
    t: Dict[str, float] = {}

    t0 = time.time()
    per_cfg = {a: dataclasses.replace(cfg, app=a) for a in apps}
    ctxs = {a: stage_prune(per_cfg[a], store, device=dev) for a in apps}
    datasets = {a: stage_dataset(per_cfg[a], store, ctxs[a], device=dev)
                for a in apps}
    t["datasets"] = time.time() - t0

    two_cfg = models.TwoStageConfig(
        gnn=gnn.GNNConfig(arch=cfg.gnn_arch, n_layers=cfg.n_layers,
                          hidden=cfg.hidden,
                          feature_dim=graph_lib.MERGED_FEATURE_DIM),
        use_critical_path=cfg.use_critical_path,
        schema_version=getattr(
            datasets[next(iter(apps))], "schema_version", 1))
    tc = training.TrainConfig(epochs=cfg.epochs, seed=cfg.seed,
                              backend=cfg.train_backend,
                              patience=cfg.early_stop_patience)
    n_pad = max(d.x.shape[1] for d in datasets.values())

    fresh: Dict[str, ds_lib.MergedDataset] = {}

    def build():
        params, merged0, metrics = training.fit_unified(
            datasets, two_cfg, tc, split=split, n_pad=n_pad, device=dev)
        fresh["merged"] = merged0
        return {"params": _np_params(params), "metrics": metrics}

    # only the fields the unified fit reads
    spec = {"apps": sorted(apps), "split": split,
            "datasets": {a: _dataset_spec(per_cfg[a]) for a in apps},
            "train": {"gnn_arch": cfg.gnn_arch, "hidden": cfg.hidden,
                      "n_layers": cfg.n_layers, "epochs": cfg.epochs,
                      "seed": cfg.seed,
                      "use_critical_path": cfg.use_critical_path,
                      "early_stop_patience": cfg.early_stop_patience,
                      "train_backend": cfg.train_backend}}
    t0 = time.time()
    fit = store.get_or_build("train_unified",
                             store.key("train_unified", spec), build)
    t["train"] = time.time() - t0
    # the merged dataset follows from the per-app datasets: reuse the one
    # the fit built on a miss, rebuild it on a hit
    merged = fresh.get("merged") or ds_lib.merge(datasets, n_pad=n_pad)

    t0 = time.time()
    params = models.params_from_numpy(fit["params"], dev)
    devices = _eval_devices(cfg, dev)
    engines = {a: SurrogateEngine.from_gnn_shared(
        two_cfg, params, merged, a, ctxs[a].entries,
        chunk_size=cfg.eval_chunk, devices=devices,
        overlap=cfg.eval_overlap, device=dev) for a in apps}
    t["engines"] = time.time() - t0
    return UnifiedResult(two_cfg, fit["params"], merged, fit["metrics"],
                         engines, t)
