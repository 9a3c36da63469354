"""Two-stage critical-path-aware prediction model (Fig. 3 of the paper).

Stage 1 — node-level classification: a GNN predicts, per arithmetic unit,
whether it lies on the accelerator's critical path. Stage 2 — graph-level
regression: the predicted bit is written into the node features (the
schema's crit column) and a second GNN regresses [area, power, latency,
ssim]. Training (teacher forcing, `losses`) comes with the port's
training slice.
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


def with_crit_bit(cfg: TwoStageConfig, x, mask, crit_logits):
    """Stage-2 input: x with the crit column set to stage 1's prediction
    (zero when the model ignores the critical path)."""
    if cfg.use_critical_path:
        bit = (torch.sigmoid(crit_logits) > 0.5).to(x.dtype)
    else:
        bit = torch.zeros_like(crit_logits)
    x2 = x.clone()
    x2[..., cfg.schema.crit_index] = bit * mask
    return x2


def predict(cfg: TwoStageConfig, params: TwoStageParams, adj, x, mask,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (targets (B,4), crit_logits (B,N)). x must arrive with the
    crit feature zeroed; it is filled here from stage 1. ``generator``
    enables dropout in both stages (training only)."""
    crit_logits = gnn.apply(cfg.stage1, params.stage1, adj, x, mask,
                            generator=generator)[..., 0]
    x2 = with_crit_bit(cfg, x, mask, crit_logits)
    y = gnn.apply(cfg.stage2, params.stage2, adj, x2, mask,
                  generator=generator)
    return y, crit_logits
