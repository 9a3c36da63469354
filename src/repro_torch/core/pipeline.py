"""App set-up of the ApproxPilot pipeline (Fig. 1).

`app_context` is the setup every stage shares: the pruned library
entries of the app's unit kinds, the design-space sizes, and the
functional model's ground truth (the 4x64x64 image set and the exact
design's output) on the requested device. The staged, cached pipeline
of `repro.core.pipeline` comes with later slices of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import torch

from repro_torch import device as device_lib
from repro_torch.accel import apps as apps_lib
from repro_torch.core import pruning
from repro_torch.data import images as images_lib


@dataclass
class AppContext:
    app_name: str
    app: apps_lib.AccelDef
    entries: Dict[str, Sequence]
    report: Dict[str, Dict]
    space: Dict[str, float]
    inp: torch.Tensor
    exact_out: torch.Tensor


def app_context(app_name: str, theta: float = 0.15, device=None
                ) -> AppContext:
    """Pruned library -> app entries -> image set -> exact output."""
    dev = device_lib.resolve(device)
    app = apps_lib.APPS[app_name]
    pruned, report = pruning.prune_library(theta=theta)
    entries = {k: pruned[k] for k in {n.kind for n in app.unit_nodes}}
    space = pruning.space_sizes(app, report)
    inp = apps_lib.app_inputs(app_name, images_lib.image_set(4, 64), dev)
    exact_out = app.run(apps_lib.make_impls(app, apps_lib.exact_choice(app)),
                        inp)
    return AppContext(app_name, app, entries, report, space, inp, exact_out)
