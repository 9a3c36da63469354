"""Training of the two-stage GNN models, in PyTorch.

Paper setup (Sec IV-A): Adam, lr 1e-3, batch 5, 100 epochs, dropout/lr
tuned on the test split. The defaults here are those of
`repro.core.training` (batch 64, 40 epochs); `TrainConfig.paper_faithful()`
gives the paper's schedule.

``fit_two_stage``
    One training loop over (epochs x steps) on the requested device
    (default: the CUDA card). Each epoch follows a batch plan drawn up
    front (`_plan_for`: one permutation per epoch, the ragged final batch
    padded with index 0 at sample weight 0, so `models.losses` masks it
    out); dropout is live, its masks drawn per step on the training
    device (`models.draw_keep`). With ``patience > 0`` a held-out split
    drives early stopping and the best-validation snapshot is returned.
    Losses stay on the device and are read once an epoch.

``fit_ensemble``
    Members grouped by GNN architecture; each group trains as ONE run
    over stacked parameters (a leading member axis) with
    `torch.func.vmap` of `torch.func.grad_and_value` over the members.
    Member m uses seed ``tc.seed + m`` for its init, its batch plan and
    its dropout stream, drawn outside the vmapped step from the member's
    own generator, so it follows the same trajectory as a single
    `fit_two_stage` with that seed.

Devices. Both take ``devices=``: the reference's count (``1`` no split,
``0`` every local device of ``device``'s type, ``N`` at most N) or an
explicit sequence of devices, which may name one device several times.

* ``fit_ensemble`` splits each architecture group's member axis over the
  largest prefix of the devices that divides it
  (`distributed.meshes.shard_leading_axis`, axis "member"): each slice
  takes its members' parameters, plans, the data and its own dropout
  generators to its device and runs the vmapped loop there, with no
  communication; the slices on distinct devices run in threads of their
  own, those on one device one after another. Members equal the
  one-device fit's.
* ``TrainConfig(data_parallel=True)`` splits the sample axis of a single
  fit over the devices in the same way (axis "data"). Every step, each
  device computes the loss terms and gradients of the minibatch rows it
  holds, over divisors of the whole minibatch (`models.losses`'
  ``denoms``), on its replica of the parameters; the gradients are summed
  on the parameters' device, Adam runs there, and the replicas take the
  new parameters. The one split that reduces: it equals the unsplit fit
  up to the summation order. For an ensemble the member split is used.

The surrogate is trained through the plain layer under autograd, as the
reference trains through plain `jnp`: the `gnn_mp` kernel has no
backward pass, and serves the trained model (`engine.from_gnn`).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import device as device_lib
from repro_torch.core import models
from repro_torch.core.dataset import AccelDataset
from repro_torch.device import DevicesLike

BACKENDS = ("scan", "loop")


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    batch_size: int = 64
    epochs: int = 40
    seed: int = 0
    # the reference's two backends (a jitted scan, a Python loop); here
    # both names run the one training loop
    backend: str = "scan"
    patience: int = 0            # >0 enables early stopping on a val split
    val_frac: float = 0.1        # held-out fraction when patience > 0
    min_delta: float = 0.0       # required val-loss improvement
    data_parallel: bool = False  # split the sample axis over devices=

    @staticmethod
    def paper_faithful() -> "TrainConfig":
        return TrainConfig(lr=1e-3, batch_size=5, epochs=100)


@dataclass
class FitHistory:
    """Per-epoch training trace returned by
    ``fit_two_stage(..., return_history=True)``."""
    train_loss: np.ndarray          # (epochs, steps) per-step total loss
    val_loss: Optional[np.ndarray]  # (epochs,) or None when no val split
    epochs_run: int                 # < epochs when early stopping fired


@dataclass
class EnsembleParams:
    """Stacked per-member parameters, grouped by architecture.

    groups[i] = (two_stage_cfg, stacked_params) where every leaf of
    stacked_params carries a leading member axis. `member_arch` lists the
    arch of each global member index (group order, then member order).
    """
    groups: List[Tuple[models.TwoStageConfig, models.TwoStageParams]]
    member_arch: List[str]

    @property
    def n_members(self) -> int:
        return len(self.member_arch)


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

def _adam_init(params) -> Dict:
    leaves = pytree.tree_leaves(params)
    return {"m": [torch.zeros_like(p) for p in leaves],
            "v": [torch.zeros_like(p) for p in leaves], "t": 0}


def _adam_update(params, grads, state, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step over a pytree of tensors; returns (params, state)
    and leaves the inputs as they were. Elementwise, so stacked ensemble
    parameters need no vmap; each line is one `torch._foreach_*` call
    over every leaf."""
    p, spec = pytree.tree_flatten(params)
    g = pytree.tree_leaves(grads)
    t = state["t"] + 1
    m = torch._foreach_mul(state["m"], b1)
    torch._foreach_add_(m, g, alpha=1 - b1)
    v = torch._foreach_mul(state["v"], b2)
    torch._foreach_addcmul_(v, g, g, value=1 - b2)
    step = torch._foreach_div(m, 1 - b1 ** t)
    denom = torch._foreach_div(v, 1 - b2 ** t)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(step, denom)
    new = torch._foreach_add(p, step, alpha=-lr)
    return pytree.tree_unflatten(new, spec), {"m": m, "v": v, "t": t}


# --------------------------------------------------------------------------
# data plumbing
# --------------------------------------------------------------------------

_DATA_KEYS = ("adj", "x", "mask", "unit_mask", "y", "crit")


def _as_data(ds, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(getattr(ds, k), np.float32)
                               ).to(dev) for k in _DATA_KEYS}


def _to_device(tree, dev: torch.device):
    """A parameter pytree (tensor or NumPy leaves) as float32 tensors on
    ``dev``."""
    return pytree.tree_map(
        lambda a: (a if isinstance(a, torch.Tensor)
                   else torch.from_numpy(np.array(a, np.float32))
                   ).to(device=dev, dtype=torch.float32), tree)


def _split_const(data: Dict[str, torch.Tensor]):
    """(varying, constant-row) split of the dataset tensors.

    Every config of one accelerator shares the graph topology, so adj,
    mask and unit_mask are usually identical across the sample axis;
    keep one row of each and expand it per step instead of gathering a
    (bs, N, N) block."""
    var, const = {}, {}
    for k, v in data.items():
        if k in ("adj", "mask", "unit_mask") and v.shape[0] > 1 and \
                bool((v == v[:1]).all()):
            const[k] = v[0]
        else:
            var[k] = v
    return var, const


def _batch_plan(generator: torch.Generator, n: int, bs: int, epochs: int):
    """(epochs, steps, bs) index and weight tensors; pad-and-mask tail.

    Every sample appears exactly once per epoch: the ragged final batch
    is padded with index 0 rows carrying weight 0."""
    steps = -(-n // bs)
    pad = steps * bs - n
    perms = torch.empty((epochs, n), dtype=torch.int64)
    for e in range(epochs):
        perms[e] = torch.randperm(n, generator=generator)
    idx = torch.cat([perms, torch.zeros((epochs, pad), dtype=perms.dtype)],
                    1)
    w = torch.cat([torch.ones((epochs, n)), torch.zeros((epochs, pad))], 1)
    return idx.reshape(epochs, steps, bs), w.reshape(epochs, steps, bs)


def _plan_for(tc: TrainConfig, n: int, bs: int):
    """(idx, w) for one training run, from a CPU generator seeded
    ``tc.seed + 1``: the same plan on every device."""
    return _batch_plan(torch.Generator().manual_seed(tc.seed + 1), n, bs,
                       tc.epochs)


def _dropout_generator(seed: int, dev: torch.device) -> torch.Generator:
    """The dropout stream of a run with ``seed``, on the training device
    (seeded apart from the plan's ``seed + 1``)."""
    s = int(np.random.SeedSequence([seed, 1]).generate_state(1)[0])
    return torch.Generator(device=dev).manual_seed(s)


def _run_inputs(cfg: models.TwoStageConfig, tc: TrainConfig, seed: int,
                n: int, dev: torch.device):
    """(params0, idx, w, dropout generator or None) of the run with
    ``seed``: parameters from a CPU generator seeded ``seed``, the batch
    plan from one seeded ``seed + 1``, the dropout stream on ``dev``. A
    single fit is the run with ``tc.seed``, ensemble member m the run
    with ``tc.seed + m``."""
    params0 = models.init(torch.Generator().manual_seed(seed), cfg,
                          device=dev)
    idx, w = _plan_for(replace(tc, seed=seed), n, min(tc.batch_size, n))
    gen = _dropout_generator(seed, dev) if cfg.gnn.dropout > 0 else None
    return params0, idx, w, gen


def _check_config(tc: TrainConfig) -> None:
    if tc.backend not in BACKENDS:
        raise ValueError(f"unknown backend {tc.backend!r}")


def _split_for_val(tc: TrainConfig, ds_train, ds_val):
    """(train, val or None): with patience, ``ds_val`` or the tail
    ``tc.val_frac`` of ``ds_train``, as the reference carves it."""
    if tc.patience <= 0:
        return ds_train, None
    if ds_val is None:
        n_total = ds_train.y.shape[0]
        n_tr = max(int(n_total * (1.0 - tc.val_frac)), 1)
        ds_train, ds_val = ds_train.split((n_tr + 0.5) / n_total)
    return ds_train, ds_val


# --------------------------------------------------------------------------
# the training step and loop
# --------------------------------------------------------------------------

def loss_and_grads(cfg: models.TwoStageConfig, params, batch,
                   keep: Optional[torch.Tensor] = None):
    """(loss, gradients) of `models.losses` at ``params`` on one batch;
    the gradients have the layout of ``params``."""
    grads, loss = torch.func.grad_and_value(
        lambda p: models.losses(cfg, p, batch, keep=keep)[0])(params)
    return loss, grads


def _make_step(cfg: models.TwoStageConfig, data, spec, use_dropout: bool,
               stacked: bool):
    """(flat params, idx, w, keep) -> (flat grads, loss); vmapped over a
    leading member axis of the parameters, the plan and the masks when
    ``stacked``."""
    var, const = _split_const(data)

    def one(flat, idx, w, keep):
        batch = {k: v[idx] for k, v in var.items()}
        bs = idx.shape[0]
        for k, row in const.items():
            batch[k] = row.expand((bs,) + row.shape)
        batch["w"] = w
        params = pytree.tree_unflatten(flat, spec)
        return models.losses(cfg, params, batch, keep=keep)[0]

    fn = torch.func.grad_and_value(one)
    if stacked:
        fn = torch.func.vmap(fn, in_dims=(0, 0, 0, 0 if use_dropout
                                          else None))
    return fn


def _make_dp_step(cfg: models.TwoStageConfig, data, spec,
                  devs: Sequence[torch.device]):
    """The data-parallel counterpart of `_make_step` for a single fit, or
    None when no prefix of more than one of ``devs`` divides the sample
    count: (flat params, idx, w, keep) -> (flat grads, loss), with ``idx``
    and ``w`` on the host and the result on the parameters' device.

    The sample axis is split over the devices (`shard_leading_axis`, axis
    "data"); each device computes the loss terms of the minibatch rows it
    holds over the whole minibatch's divisors, and their gradients on its
    replica of the parameters. Every device's part is issued before the
    gradients and losses are summed in device order."""
    from repro_torch.distributed import meshes
    n = data["x"].shape[0]
    sh = meshes.shard_leading_axis(data, n, axis_name="data", devices=devs)
    if not isinstance(sh, meshes.Sharded):
        return None
    parts = [(d, *_split_const(shard))
             for d, shard in zip(sh.mesh.device_list(), sh.shards)]
    per = n // len(parts)
    dt = data["x"].dtype
    um_rows = data["unit_mask"].sum(-1).cpu()      # exact small integers

    def one(flat, batch, keep, denoms):
        return models.losses(cfg, pytree.tree_unflatten(flat, spec), batch,
                             keep=keep, denoms=denoms)[0]

    grad_fn = torch.func.grad_and_value(one)

    def step(flat, idx, w, keep):
        home = flat[0].device
        denoms = (torch.clamp(w.sum(), min=1.0),
                  torch.clamp((w * um_rows[idx].to(w.dtype)).sum(), min=1.0))
        owner = idx // per
        out = []
        for i, (d, var, const) in enumerate(parts):
            sel = torch.nonzero(owner == i)[:, 0]
            if not len(sel):
                continue
            local = (idx[sel] - i * per).to(d)
            batch = {k: v[local] for k, v in var.items()}
            for k, row in const.items():
                batch[k] = row.expand((len(sel),) + row.shape)
            batch["w"] = w[sel].to(device=d, dtype=dt)
            kd = None if keep is None else keep[:, :, sel.to(keep.device)
                                                ].to(d)
            out.append(grad_fn([p.to(d) for p in flat], batch, kd,
                               tuple(x.to(device=d, dtype=dt)
                                     for x in denoms)))
        grads = [g.to(home) for g in out[0][0]]
        loss = out[0][1].to(home)
        for g_d, l_d in out[1:]:
            torch._foreach_add_(grads, [g.to(home) for g in g_d])
            loss = loss + l_d.to(home)
        return grads, loss

    return step


def _fit(cfg: models.TwoStageConfig, tc: TrainConfig, data, params0, idx,
         w, generator, val_data=None, devices=None):
    """The training loop. ``idx``/``w`` is the (epochs, steps, bs) batch
    plan; ``generator`` draws the dropout masks (None: no dropout). With
    ``devices`` (several), a single fit's sample axis is split over them
    (`_make_dp_step`).

    For an ensemble group the parameters carry a leading member axis,
    the plan is (members, epochs, steps, bs) and ``generator`` is one
    generator per member; each member stops early on its own, as under
    the reference's vmapped scan. Returns (params, (train_loss,
    val_loss, active)) with the reference's layout: NaN losses in the
    epochs after a stop."""
    stacked = idx.dim() == 4
    lead = (idx.shape[0],) if stacked else ()
    E, S = idx.shape[-3:-1]
    dev = pytree.tree_leaves(params0)[0].device
    flat, spec = pytree.tree_flatten(params0)
    flat = [p.detach().clone() for p in flat]
    use_do = cfg.gnn.dropout > 0 and generator is not None
    step = None
    if devices is not None and len(devices) > 1 and not stacked:
        step = _make_dp_step(cfg, data, spec, devices)
        idx, w = idx.cpu(), w.cpu()
    if step is None:
        idx, w = idx.to(dev), w.to(dev)
        step = _make_step(cfg, data, spec, use_do, stacked)
    N = data["x"].shape[1]
    bs = idx.shape[-1]
    early = tc.patience > 0 and val_data is not None
    if early:
        def val_one(f):
            return models.losses(cfg, pytree.tree_unflatten(f, spec),
                                 val_data)[0]
        val_of = torch.func.vmap(val_one) if stacked else val_one
        best = [p.clone() for p in flat]
        best_val = np.full(lead, np.inf, np.float32)
        bad = np.zeros(lead, np.int64)
        stopped = np.zeros(lead, bool)

    def keep_masks():
        if not use_do:
            return None
        if stacked:
            return torch.stack([models.draw_keep(cfg, g, bs, N)
                                for g in generator])
        return models.draw_keep(cfg, generator, bs, N)

    opt = _adam_init(flat)
    tr = np.full(lead + (E, S), np.nan, np.float32)
    vls = np.full(lead + (E,), np.nan, np.float32)
    act = np.zeros(lead + (E,), bool)
    with torch.no_grad():
        for ep in range(E):
            if early and stopped.all():
                break
            losses = []
            for s in range(S):
                grads, loss = step(flat, idx[..., ep, s, :],
                                   w[..., ep, s, :], keep_masks())
                flat, opt = _adam_update(flat, grads, opt, tc.lr)
                losses.append(loss)
            ep_loss = torch.stack(losses, -1)
            if not early:
                tr[..., ep, :] = ep_loss.cpu().numpy()
                act[..., ep] = True
                continue
            vl = val_of(flat)
            ep_loss, vl = ep_loss.cpu().numpy(), vl.cpu().numpy()
            active = ~stopped
            improved = active & (vl < best_val - tc.min_delta)
            sel = torch.as_tensor(improved, device=dev)
            best = [torch.where(sel.reshape(lead + (1,) * (b.dim()
                                                           - len(lead))),
                                p, b) for p, b in zip(flat, best)]
            best_val = np.where(improved, vl, best_val)
            bad = np.where(improved, 0, bad + 1)
            stopped = stopped | (bad >= tc.patience)
            tr[..., ep, :] = np.where(active[..., None], ep_loss, np.nan)
            vls[..., ep] = np.where(active, vl, np.nan)
            act[..., ep] = active
    out = best if early else flat
    return pytree.tree_unflatten(out, spec), (tr, vls, act)


def fit_two_stage(cfg: models.TwoStageConfig, ds_train: AccelDataset,
                  tc: TrainConfig = TrainConfig(),
                  log_every: int = 0, return_history: bool = False,
                  ds_val: Optional[AccelDataset] = None,
                  params0: Optional[models.TwoStageParams] = None,
                  device=None, devices: DevicesLike = 1):
    """Train the two-stage model on ``device`` (default: the CUDA card);
    returns params (and a `FitHistory` if asked). With
    ``tc.data_parallel``, the sample axis is split over ``devices``
    (module docstring); otherwise ``devices`` has nothing to split.

    With ``tc.patience > 0``, a validation split (``ds_val``, or
    ``tc.val_frac`` carved off the tail of ``ds_train``) drives early
    stopping and the best-validation snapshot is returned. ``params0``
    warm-starts from existing parameters (tensor or NumPy leaves); else
    the parameters are drawn from a CPU generator seeded ``tc.seed``
    (`_run_inputs`)."""
    _check_config(tc)
    dev = device_lib.resolve(device)
    ds_train, ds_val = _split_for_val(tc, ds_train, ds_val)
    val_data = None if ds_val is None else _as_data(ds_val, dev)
    data = _as_data(ds_train, dev)
    n = ds_train.y.shape[0]
    init, idx, w, gen = _run_inputs(cfg, tc, tc.seed, n, dev)
    params0 = init if params0 is None else _to_device(params0, dev)
    devs = device_lib.device_list(devices, dev) if tc.data_parallel \
        else None
    params, (tr, vls, act) = _fit(cfg, tc, data, params0, idx, w, gen,
                                  val_data, devices=devs)
    if log_every:
        for ep in range(tc.epochs):
            if act[ep] and (ep + 1) % log_every == 0:
                print(f"  epoch {ep + 1}/{tc.epochs} "
                      f"loss={float(np.nanmean(tr[ep])):.4f}")
    if return_history:
        return params, FitHistory(
            train_loss=tr, val_loss=vls if val_data is not None else None,
            epochs_run=int(act.sum()))
    return params


# --------------------------------------------------------------------------
# ensembles
# --------------------------------------------------------------------------

def _stack(trees):
    return pytree.tree_map(lambda *xs: torch.stack(xs), *trees)


def _fit_split(cfg: models.TwoStageConfig, tc: TrainConfig, data,
               params0, idx, w, seeds: Sequence[int], val_data,
               devs: Sequence[torch.device]):
    """`_fit` of a group of stacked members with the member axis split
    over ``devs`` (`shard_leading_axis`, axis "member"); the members'
    dropout generators are made from ``seeds`` on each slice's device.
    Returns what `_fit` returns, gathered on ``params0``'s device."""
    from repro_torch.distributed import meshes
    home = pytree.tree_leaves(params0)[0].device
    use_do = cfg.gnn.dropout > 0
    sh = meshes.shard_leading_axis((params0, idx, w), idx.shape[0],
                                   axis_name="member", devices=devs)
    if not isinstance(sh, meshes.Sharded):
        gens = [_dropout_generator(s, home) for s in seeds] \
            if use_do else None
        return _fit(cfg, tc, data, params0, idx, w, gens, val_data)
    slice_devs = sh.mesh.device_list()
    per = len(seeds) // len(slice_devs)
    copies: Dict[torch.device, Tuple] = {}
    for d in slice_devs:
        if d not in copies:
            copies[d] = (pytree.tree_map(lambda a: a.to(d), data),
                         None if val_data is None else
                         pytree.tree_map(lambda a: a.to(d), val_data))
    results: List = [None] * len(slice_devs)

    def run(i: int) -> None:
        d = slice_devs[i]
        p_i, idx_i, w_i = sh.shards[i]
        gens = [_dropout_generator(s, d) for s in
                seeds[i * per:(i + 1) * per]] if use_do else None
        results[i] = _fit(cfg, tc, copies[d][0], p_i, idx_i, w_i, gens,
                          copies[d][1])

    by_dev: Dict[torch.device, List[int]] = {}
    for i, d in enumerate(slice_devs):
        by_dev.setdefault(d, []).append(i)
    if len(by_dev) == 1:
        for i in range(len(slice_devs)):
            run(i)
    else:
        errors: List[BaseException] = []

        def worker(ids: List[int]) -> None:
            try:
                for i in ids:
                    run(i)
            except BaseException as e:       # re-raised on this thread
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(ids,))
                   for ids in by_dev.values()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
    params = pytree.tree_map(lambda *xs: torch.cat([x.to(home) for x in xs]),
                             *[r[0] for r in results])
    hist = tuple(np.concatenate([r[1][j] for r in results], 0)
                 for j in range(3))
    return params, hist


def fit_ensemble(cfg: models.TwoStageConfig, ds_train: AccelDataset,
                 tc: TrainConfig = TrainConfig(), n_members: int = 8,
                 archs: Optional[Sequence[str]] = None,
                 ds_val: Optional[AccelDataset] = None, device=None,
                 devices: DevicesLike = 1
                 ) -> Tuple[EnsembleParams, Dict[str, np.ndarray]]:
    """Train ``n_members`` independent models on ``device``, each
    architecture group as one run over stacked parameters, its member
    axis split over ``devices`` (module docstring).

    Member m uses seed ``tc.seed + m`` for its init, its batch plan and
    its dropout stream, so it follows a single
    ``fit_two_stage(..., TrainConfig(seed=tc.seed + m))``. ``archs``
    assigns each member a GNN architecture; members are grouped per arch.

    Returns (EnsembleParams, history dict with per-member (M, E, S) train
    losses and (M,) epochs_run)."""
    if n_members < 1:
        raise ValueError("n_members must be >= 1")
    member_arch = list(archs) if archs else [cfg.gnn.arch] * n_members
    if len(member_arch) != n_members:
        raise ValueError("len(archs) must equal n_members")
    _check_config(tc)
    dev = device_lib.resolve(device)
    ds_train, ds_val = _split_for_val(tc, ds_train, ds_val)
    val_data = None if ds_val is None else _as_data(ds_val, dev)
    data = _as_data(ds_train, dev)
    n = ds_train.y.shape[0]
    devs = device_lib.device_list(devices, dev)

    groups: List[Tuple[models.TwoStageConfig, models.TwoStageParams]] = []
    hist_tr, hist_eps, order = [], [], []
    for arch in dict.fromkeys(member_arch):          # stable unique order
        members = [m for m, a in enumerate(member_arch) if a == arch]
        g_cfg = replace(cfg, gnn=replace(cfg.gnn, arch=arch))
        runs = [_run_inputs(g_cfg, tc, tc.seed + m, n, dev)
                for m in members]
        params0, idx, w, _gens = (list(r) for r in zip(*runs))
        params, (tr, _vls, act) = _fit_split(
            g_cfg, tc, data, _stack(params0), torch.stack(idx),
            torch.stack(w), [tc.seed + m for m in members], val_data, devs)
        groups.append((g_cfg, params))
        hist_tr.append(tr)
        hist_eps.append(act.sum(-1))
        order.extend([arch] * len(members))
    history = {"train_loss": np.concatenate(hist_tr, 0),
               "epochs_run": np.concatenate(hist_eps, 0)}
    return EnsembleParams(groups=groups, member_arch=order), history


def _inputs(dev, *arrays):
    return [torch.as_tensor(np.asarray(a, np.float32)).to(dev)
            if not isinstance(a, torch.Tensor) else a.to(dev)
            for a in arrays]


def _group_on(ens: EnsembleParams, dev):
    return [(g_cfg, _to_device(params, dev)) for g_cfg, params in ens.groups]


def ensemble_predict(ens: EnsembleParams, adj, x, mask, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All-member predictions on ``device``: (mean (B,4), std (B,4),
    stacked (M,B,4)). Deterministic: no dropout at inference."""
    dev = device_lib.resolve(device)
    adj, x, mask = _inputs(dev, adj, x, mask)
    with torch.no_grad():
        Y = torch.cat([torch.func.vmap(
            lambda p, g_cfg=g_cfg: models.predict(g_cfg, p, adj, x,
                                                  mask)[0])(params)
            for g_cfg, params in _group_on(ens, dev)], 0)
    return Y.mean(0), Y.std(0, correction=0), Y


def _crit_accuracy(pred_bits: np.ndarray, ds_test) -> float:
    um = ds_test.unit_mask > 0
    correct = pred_bits == (ds_test.crit > 0.5)
    return float(correct[um].mean()) if um.any() else 1.0


def _target_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> Dict:
    return {t: {"r2": r2_score(y_true[:, i], y_pred[:, i]),
                "mape": mape(y_true[:, i], y_pred[:, i])}
            for i, t in enumerate(models.TARGETS)}


def evaluate_ensemble(ens: EnsembleParams, ds: AccelDataset,
                      ds_test: AccelDataset, device=None) -> Dict[str, Dict]:
    """`evaluate` on the ensemble-mean prediction plus the per-target
    mean std (denormalized), the uncertainty column the search sees."""
    dev = device_lib.resolve(device)
    adj, x, mask = _inputs(dev, ds_test.adj, ds_test.x, ds_test.mask)
    mean, std, _ = ensemble_predict(ens, adj, x, mask, device=dev)
    y_pred = ds.denorm_y(mean.cpu().numpy())
    std_dn = std.cpu().numpy() * np.asarray(ds.y_std)
    out: Dict[str, Dict] = _target_metrics(ds_test.y_raw, y_pred)
    for i, t in enumerate(models.TARGETS):
        out[t]["mean_std"] = float(std_dn[:, i].mean())
    with torch.no_grad():
        crit_probs = torch.cat([torch.sigmoid(torch.func.vmap(
            lambda p, g_cfg=g_cfg: models.predict_critical(
                g_cfg, p, adj, x, mask))(params))
            for g_cfg, params in _group_on(ens, dev)], 0)   # (M, B, N)
    out["critical_path"] = {"accuracy": _crit_accuracy(
        (crit_probs.mean(0) > 0.5).cpu().numpy(), ds_test)}
    return out


# --------------------------------------------------------------------------
# evaluation / metrics
# --------------------------------------------------------------------------

def _predict_np(cfg, params, d, dev):
    adj, x, mask = _inputs(dev, d.adj, d.x, d.mask)
    with torch.no_grad():
        y, logits = models.predict(cfg, _to_device(params, dev), adj, x,
                                   mask)
    return y.cpu().numpy(), (torch.sigmoid(logits) > 0.5).cpu().numpy()


def evaluate(cfg: models.TwoStageConfig, params: models.TwoStageParams,
             ds: AccelDataset, ds_test: AccelDataset, device=None
             ) -> Dict[str, Dict]:
    """R2 + MAPE per target (denormalized), + critical-path accuracy, on
    ``device``. No dropout: deterministic regardless of
    ``cfg.gnn.dropout``."""
    y, bits = _predict_np(cfg, params, ds_test, device_lib.resolve(device))
    out = _target_metrics(ds_test.y_raw, ds.denorm_y(y))
    out["critical_path"] = {"accuracy": _crit_accuracy(bits, ds_test)}
    return out


def evaluate_merged(cfg: models.TwoStageConfig,
                    params: models.TwoStageParams, mds, device=None
                    ) -> Dict[str, Dict]:
    """`evaluate` for a `dataset.MergedDataset` (or a `.view(app)` of
    one): predictions denormalized per row with each row's app stats."""
    y, bits = _predict_np(cfg, params, mds, device_lib.resolve(device))
    out = _target_metrics(mds.y_raw, mds.denorm_rows(y))
    out["critical_path"] = {"accuracy": _crit_accuracy(bits, mds)}
    return out


def fit_unified(datasets: Dict[str, AccelDataset],
                cfg: models.TwoStageConfig, tc: TrainConfig = TrainConfig(),
                split: float = 0.9, n_pad: Optional[int] = None,
                params0: Optional[models.TwoStageParams] = None,
                device=None):
    """Fit ONE shared two-stage GNN over the union of per-app datasets.

    Returns (params, merged, metrics) where ``metrics`` holds the overall
    test-split quality plus a per-app breakdown (``metrics["per_app"]``).
    ``cfg.gnn.feature_dim`` must be `graph.MERGED_FEATURE_DIM`."""
    from repro_torch.core import dataset as ds_lib
    from repro_torch.core.graph import MERGED_FEATURE_DIM

    if cfg.gnn.feature_dim != MERGED_FEATURE_DIM:
        raise ValueError(
            f"unified surrogate needs feature_dim={MERGED_FEATURE_DIM} "
            f"(got {cfg.gnn.feature_dim}); build the GNNConfig with "
            f"feature_dim=graph.MERGED_FEATURE_DIM")
    dev = device_lib.resolve(device)
    merged = ds_lib.merge(datasets, n_pad=n_pad)
    tr, te = merged.split(split)
    params = fit_two_stage(cfg, tr, tc, params0=params0, device=dev)
    metrics = evaluate_merged(cfg, params, te, device=dev)
    metrics["per_app"] = {
        a: evaluate_merged(cfg, params, te.view(a), device=dev)
        for a in merged.app_names if (te.app_ids ==
                                      merged.app_names.index(a)).any()}
    return params, merged, metrics


def evaluate_transfer(datasets: Dict[str, AccelDataset], holdout: str,
                      cfg: models.TwoStageConfig,
                      tc: TrainConfig = TrainConfig(),
                      finetune_epochs: int = 5, split: float = 0.9,
                      device=None) -> Dict[str, object]:
    """Leave-one-app-out transfer quality of the unified surrogate.

    Trains the shared model on every app except ``holdout``, then reports
    per-objective R2/MAPE on the holdout app's test split twice:
    ``zero_shot`` (the shared params as they are) and ``fine_tuned``
    (after ``finetune_epochs`` warm-started epochs on the holdout's train
    split).

    Returns {holdout, shared_apps, shared_metrics, zero_shot, fine_tuned,
    finetune_epochs}."""
    from repro_torch.core import dataset as ds_lib

    if holdout not in datasets:
        raise ValueError(f"holdout {holdout!r} not in {sorted(datasets)}")
    rest = {a: d for a, d in datasets.items() if a != holdout}
    if not rest:
        raise ValueError("evaluate_transfer needs >= 2 apps")
    dev = device_lib.resolve(device)
    n_pad = max(d.x.shape[1] for d in datasets.values())
    params, _merged, shared_metrics = fit_unified(rest, cfg, tc, split,
                                                  n_pad=n_pad, device=dev)
    hold = ds_lib.merge({holdout: datasets[holdout]}, n_pad=n_pad)
    tr_h, te_h = hold.split(split)
    zero_shot = evaluate_merged(cfg, params, te_h, device=dev)
    ft_tc = replace(tc, epochs=finetune_epochs, patience=0)
    ft_params = fit_two_stage(cfg, tr_h, ft_tc, params0=params, device=dev)
    fine_tuned = evaluate_merged(cfg, ft_params, te_h, device=dev)
    return {"holdout": holdout, "shared_apps": sorted(rest),
            "shared_metrics": shared_metrics, "zero_shot": zero_shot,
            "fine_tuned": fine_tuned, "finetune_epochs": finetune_epochs}


def r2_score(y, yh) -> float:
    ss_res = float(((y - yh) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum()) + 1e-12
    return 1.0 - ss_res / ss_tot


def mape(y, yh) -> float:
    denom = np.maximum(np.abs(y), 1e-6)
    return float(np.mean(np.abs(yh - y) / denom))
