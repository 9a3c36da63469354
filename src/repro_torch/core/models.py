"""Two-stage critical-path-aware prediction model (Fig. 3 of the paper).

Stage 1 — node-level classification: a GNN predicts, per arithmetic unit,
whether it lies on the accelerator's critical path. Stage 2 — graph-level
regression: the predicted bit is written into the node features (the
schema's crit column) and a second GNN regresses [area, power, latency,
ssim]. During training stage 2 is teacher-forced with the true bits
(`losses`); at inference it takes stage 1's predictions.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import gnn
from repro_torch.core import graph as graph_lib

TARGETS = ("area", "power", "latency", "ssim")


@dataclass(frozen=True)
class TwoStageConfig:
    gnn: gnn.GNNConfig = gnn.GNNConfig()
    use_critical_path: bool = True
    # feature-schema version the model was trained against; locates the
    # crit column
    schema_version: int = graph_lib.ACTIVE_SCHEMA.version

    @property
    def schema(self) -> graph_lib.FeatureSchema:
        return graph_lib.schema_for(self.schema_version)

    @property
    def stage1(self) -> gnn.GNNConfig:
        return replace(self.gnn, node_level=True, out_dim=1)

    @property
    def stage2(self) -> gnn.GNNConfig:
        return replace(self.gnn, node_level=False, out_dim=len(TARGETS))


class TwoStageParams(NamedTuple):
    stage1: Dict
    stage2: Dict


def init(generator: torch.Generator, cfg: TwoStageConfig, device=None
         ) -> TwoStageParams:
    """Random two-stage parameters drawn from ``generator``."""
    return TwoStageParams(gnn.init_params(generator, cfg.stage1, device),
                          gnn.init_params(generator, cfg.stage2, device))


def params_from_numpy(np_params, device=None) -> TwoStageParams:
    """Carry the reference's weights across: ``np_params`` is a
    ``(stage1, stage2)`` pair of NumPy parameter dicts in the layout
    `repro.core.pipeline._np_params` writes (a `TwoStageParams` of the
    JAX package, converted leaf by leaf)."""
    dev = device_lib.resolve(device)

    def conv(p):
        if isinstance(p, dict):
            return {k: conv(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return [conv(v) for v in p]
        return torch.from_numpy(np.array(p, np.float32)).to(dev)

    stage1, stage2 = np_params
    return TwoStageParams(conv(stage1), conv(stage2))


def _set_crit(cfg: TwoStageConfig, x, mask, bit):
    """x with the schema's crit column replaced by ``bit * mask`` (a
    select, so it runs under autograd and `torch.func.vmap`)."""
    col = torch.arange(x.shape[-1], device=x.device) == cfg.schema.crit_index
    return torch.where(col, (bit * mask)[..., None], x)


def with_crit_bit(cfg: TwoStageConfig, x, mask, crit_logits):
    """Stage-2 input: x with the crit column set to stage 1's prediction
    (zero when the model ignores the critical path)."""
    if cfg.use_critical_path:
        bit = (torch.sigmoid(crit_logits) > 0.5).to(x.dtype)
    else:
        bit = torch.zeros_like(crit_logits)
    return _set_crit(cfg, x, mask, bit)


def draw_keep(cfg: TwoStageConfig, generator: torch.Generator, B: int,
              N: int) -> torch.Tensor:
    """One training step's dropout masks for both stages, drawn from
    ``generator`` on its device: (2, n_layers, B, N, hidden) booleans,
    True where an activation is kept."""
    return gnn.draw_keep(cfg.gnn, generator, B, N, lead=(2,))


def predict_critical(cfg: TwoStageConfig, params: TwoStageParams, adj, x,
                     mask) -> torch.Tensor:
    """(B,N) logits for on-critical-path."""
    return gnn.apply(cfg.stage1, params.stage1, adj, x, mask)[..., 0]


def predict(cfg: TwoStageConfig, params: TwoStageParams, adj, x, mask,
            teacher_crit=None, keep: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (targets (B,4), crit_logits (B,N)).

    x must arrive with the crit feature zeroed; it is filled here from
    stage 1, or from ``teacher_crit`` during stage-2 training. ``keep``
    (`draw_keep`) enables dropout in both stages (training only:
    inference and `training.evaluate` never pass it)."""
    k1, k2 = (None, None) if keep is None else (keep[0], keep[1])
    crit_logits = gnn.apply(cfg.stage1, params.stage1, adj, x, mask,
                            keep=k1)[..., 0]
    if cfg.use_critical_path and teacher_crit is not None:
        x2 = _set_crit(cfg, x, mask, teacher_crit)
    else:
        x2 = with_crit_bit(cfg, x, mask, crit_logits)
    y = gnn.apply(cfg.stage2, params.stage2, adj, x2, mask, keep=k2)
    return y, crit_logits


def losses(cfg: TwoStageConfig, params: TwoStageParams, batch,
           keep: Optional[torch.Tensor] = None, denoms=None
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: {adj, x (crit zeroed), mask, y (B,4), crit (B,N), unit_mask,
    w (optional (B,) sample weights: 0 rows are padding and contribute
    nothing to either loss term or its gradients)}. Stage 2 is
    teacher-forced with the true crit bits. ``keep`` (`draw_keep`) turns
    dropout on.

    ``denoms`` (with ``w``) is the pair of divisors of the two terms, in
    place of this batch's own: the weight sum and the weighted unit-mask
    sum of a whole minibatch, of which ``batch`` holds some rows. The
    terms of the parts then add up to the whole minibatch's (the
    data-parallel split of `training`)."""
    y_pred, crit_logits = predict(cfg, params, batch["adj"], batch["x"],
                                  batch["mask"], teacher_crit=batch["crit"],
                                  keep=keep)
    um = batch.get("unit_mask", batch["mask"])
    w = batch.get("w")
    per_sample = ((y_pred - batch["y"]) ** 2).mean(-1)
    if w is None:
        reg = per_sample.mean()
    else:
        um = um * w[..., None]
    w_den, um_den = denoms if denoms is not None else (
        None if w is None else torch.clamp(w.sum(), min=1.0),
        torch.clamp(um.sum(), min=1.0))
    if w is not None:
        reg = (w * per_sample).sum() / w_den
    # log(1 + e^l) as the reference writes it (softplus switches to the
    # identity past its threshold)
    bce = (um * (torch.logaddexp(torch.zeros_like(crit_logits), crit_logits)
                 - crit_logits * batch["crit"])).sum() / um_den
    total = reg + bce if cfg.use_critical_path else reg
    return total, {"reg_mse": reg, "crit_bce": bce}
