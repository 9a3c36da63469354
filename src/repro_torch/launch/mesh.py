"""Production mesh builders.

The port of `repro.launch.mesh`. Single pod: 16x16 = 256 devices
("data","model"). Multi-pod: 2x16x16 = 512 devices ("pod","data",
"model"), "pod" the axis of pure data parallelism.

Each builder takes the devices from ``devices`` (default: every local
device, `device.local_devices`) and raises `ValueError` when fewer exist
than the mesh needs, as `jax.make_mesh` does. An explicit list may name
one device several times.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch import device as device_lib
from repro_torch.distributed.meshes import Mesh, mesh_of


def make_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over the first prod(shape) of ``devices``."""
    devs = list(devices) if devices is not None \
        else device_lib.local_devices()
    need = int(np.prod(shape))
    if len(devs) < need:
        raise ValueError(f"the mesh {tuple(shape)} needs {need} devices; "
                         f"{len(devs)} are available")
    return mesh_of(devs[:need], tuple(shape), tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_smoke_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-device mesh with the same axis names."""
    return make_mesh((1, 1), ("data", "model"), devices)


def make_mesh_for(n_devices: int, *, data_model_ratio: float = 1.0,
                  devices: Optional[Sequence] = None) -> Mesh:
    """Elastic-scaling helper: best (data, model) factorization of n."""
    best = (n_devices, 1)
    for m in range(1, n_devices + 1):
        if n_devices % m:
            continue
        d = n_devices // m
        if abs(d / m - data_model_ratio) < abs(best[0] / best[1]
                                               - data_model_ratio):
            best = (d, m)
    return make_mesh(best, ("data", "model"), devices)
