"""The system under test, the port `repro_torch` (under ``src/`` of the
checkout), as the benchmark drives it. The only module of the harness
that imports it: the entries a window drives, the layout of their
outputs, the program's span names. Nothing here imports JAX or the JAX
package `repro`."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Dict, List

import torch

from pbench import weights


def load(root: Path) -> None:
    """Put the checkout's ``src/`` on the path; raise if the port is not
    there."""
    src = Path(root) / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise FileNotFoundError(f"the program is missing: no "
                                f"{src / 'repro_torch'}")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))


def set_precision() -> None:
    """The card's settings the program's numerics are written for
    (`models/layers.py::fdot`): float32 products in float32, bf16
    products reduced in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False


def arch_config(conf: dict):
    """The program's `ArchConfig` of the configuration file: its
    registered architecture with every key of the file that names a
    field."""
    from repro_torch.configs import get_arch
    base = get_arch(conf["arch"])
    fields = {f.name for f in dataclasses.fields(base)} - {"name"}
    over = {k: tuple(v) if isinstance(v, list) else v
            for k, v in conf.items() if k in fields}
    return dataclasses.replace(base, **over)


def check_weights(cfg, flat: Dict[str, torch.Tensor]) -> None:
    """The drawn leaves have the program's paths and shapes."""
    from repro_torch.models import transformer
    want = {p: tuple(t.shape) for p, t in weights.flatten(
        transformer.build_param_table(cfg).shapes()).items()}
    got = {p: tuple(t.shape) for p, t in flat.items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"the reference's weights differ from the "
                         f"program's: {diff[:6]}")


def spans() -> tuple:
    """The program's `record_function` spans of its kernels."""
    from repro_torch.kernels import ops
    return tuple(ops.SPANS)


class Prefill:
    """`launch/steps.py::make_prefill_step`: (params, batch) -> (last
    logits (B,V), cache)."""

    def __init__(self, conf: dict):
        from repro_torch.launch import steps
        self.cfg = arch_config(conf)
        self.fn = steps.make_prefill_step(self.cfg)

    def __call__(self, params, batch):
        return self.fn(params, batch)

    def cache_entries(self, cache) -> Dict[str, List[torch.Tensor]]:
        """Each layer's k and v (B,W,KV,D) and slot positions (B,W)."""
        if "k" not in cache:
            raise NotImplementedError(
                f"the {self.cfg.family} family's cache layout")
        L = cache["k"].shape[0]
        return {"k": list(cache["k"].unbind(0)),
                "v": list(cache["v"].unbind(0)),
                "pos": [cache["pos"]] * L}

