"""Pipeline parallelism: GPipe micro-batch pipelining over a stage mesh.

The port of `repro.distributed.pipeline`. The layer stack is split into
``n_stages`` equal groups along the (already stacked) layer axis, and
stage ``s``'s group lives on the stage axis's device ``s``. The reference
writes the schedule as a ``shard_map`` over the stage axis with a
``ppermute`` between ticks; here one process drives it as a host loop
(single-controller): at each tick every stage with a valid micro-batch is
launched on its device, then each activation moves one hop down the pipe
with ``.to(next_device, non_blocking=True)``.

Schedule: with M micro-batches and P stages the loop runs M + P - 1
ticks; at tick t stage s runs micro-batch t - s when that index is valid,
and the last stage emits output t - (P - 1). Bubble fraction =
(P-1)/(M+P-1), reported by `bubble_fraction`.

A stage mesh may name one device several times: its stages then run one
after another on that device's stream. The schedule is exact there and
the output equals the sequential stack's, but nothing overlaps; the
overlap needs a device per stage.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.distributed.meshes import Mesh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.layers import tree_map


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipelined(stage_fn: Callable, n_stages: int, n_micro: int,
              mesh: Mesh, stage_axis: str = "stage"):
    """Build a pipelined apply over a stage-split parameter stack.

    ``stage_fn(stage_params, x) -> x`` is applied per stage;
    ``stage_params`` is the per-stage slice of a (n_stages, ...) tree.

    Returns ``apply(params_stacked, xs)`` where xs is (n_micro, B, ...)
    micro-batched inputs; the output is (n_micro, B, ...) after all
    stages, gathered on the mesh's first device."""
    devs: List[torch.device] = list(mesh.devices.reshape(-1))
    if mesh.shape.get(stage_axis) != n_stages or len(devs) != n_stages:
        raise ValueError(f"a {n_stages}-stage pipeline needs a 1-d mesh of "
                         f"{n_stages} devices on {stage_axis!r}, got "
                         f"{dict(mesh.shape)}")

    def apply(params_stacked, xs: torch.Tensor) -> torch.Tensor:
        # stage s's slice on device s (a view where it already lives)
        stage_params = [tree_map(lambda a, s=s: a[s].to(devs[s]),
                                 params_stacked) for s in range(n_stages)]
        inbox: List[Optional[torch.Tensor]] = [None] * n_stages
        outs: List[Optional[torch.Tensor]] = [None] * n_micro
        for t in range(n_micro + n_stages - 1):
            ys: List[Optional[torch.Tensor]] = [None] * n_stages
            for s in range(n_stages):
                m = t - s
                if not 0 <= m < n_micro:
                    continue
                x = xs[m].to(devs[0], non_blocking=True) if s == 0 \
                    else inbox[s]
                ys[s] = stage_fn(stage_params[s], x)
            # every stage of the tick is issued; now one hop down the pipe
            for s in range(n_stages - 1):
                inbox[s + 1] = None if ys[s] is None else \
                    ys[s].to(devs[s + 1], non_blocking=True)
            if ys[-1] is not None:
                outs[t - (n_stages - 1)] = ys[-1].to(devs[0],
                                                     non_blocking=True)
        return torch.stack(outs)

    return apply


def make_stage_mesh(n_stages: int, devices: Optional[Sequence] = None
                    ) -> Mesh:
    """1-d ("stage",) mesh over the first ``n_stages`` of ``devices``
    (default: every local device)."""
    return make_mesh((n_stages,), ("stage",), devices)
