"""Dry run of the port's steps on one card: the counterpart of
`repro.launch.dryrun`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape train_4k

For every (architecture x input shape) cell, `run_cell` builds the port's
own step (`launch/steps.py`: `make_train_step` with the shape's
``grad_accum`` and the config's remat, `make_prefill_step`, or
`make_decode_step` over a cache of the shape's length) on meta tensors
at the shape's full global batch, counts it with `op_profile.profile`,
and appends the reference's record fields to `roofline.RESULTS`
(``build/dryrun_torch.json``), keyed on (arch, shape), which
`launch/roofline.py` reads. Nothing
runs on a device, so the CLI needs no card.

Against the reference: one card, so ``"mesh": "1"`` and ``"chips": 1``
and no collective bytes. Nothing is lowered or compiled, so there are no
``lower_s``/``compile_s``: ``count_s`` is the count's host seconds. The
reference's ``--multi-pod``, ``--both-meshes`` and ``--rules`` choose
meshes and sharding rules; the port now has the rules and the plans
(`launch.steps.plan`) but counts one card here: the flags come with the
per-device counts on 256- and 512-position meshes, the third of the
slices after the dense LM on a mesh (ROADMAP.md queue 1). RWKV-6's
recurrence is a step loop of three ops a token and a layer, so its cells
walk millions of ops and take minutes.
"""
from __future__ import annotations

import argparse
import json
import traceback
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape, supports
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import op_profile, roofline
from repro_torch.launch import steps as steps_lib
from repro_torch.models import decoding, transformer
from repro_torch.models.layers import _assign
from repro_torch.optim import adamw


def meta_params(cfg: ArchConfig, dtype: torch.dtype) -> Dict[str, Any]:
    """The parameter tree of ``cfg`` as meta tensors of ``dtype``."""
    params: Dict[str, Any] = {}
    for path, (shape, _kind, _scale) in sorted(
            transformer.build_param_table(cfg).defs.items()):
        _assign(params, path, torch.empty(shape, dtype=dtype, device="meta"))
    return params


def _meta_inputs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    return {k: torch.empty(s, dtype=dt, device="meta")
            for k, (s, dt) in steps_lib.input_specs(cfg, shape).items()}


def build_step(cfg: ArchConfig, shape: ShapeConfig, max_len: int = 0
               ) -> Tuple[Callable, tuple]:
    """(step, its meta arguments) of a cell, as the reference's
    `steps.plan` lays them out: float32 master parameters, AdamW state
    and the batch (train); bf16 parameters and the prompt (prefill, its
    cache ``max(max_len, S)`` slots); bf16 parameters, a cache of the
    shape's length and one token a sequence at the last position
    (decode)."""
    if shape.kind == "train":
        params = meta_params(cfg, torch.float32)
        return (steps_lib.make_train_step(cfg, shape),
                (params, adamw.init(params), _meta_inputs(cfg, shape)))
    params = meta_params(cfg, torch.bfloat16)
    if shape.kind == "prefill":
        return (steps_lib.make_prefill_step(cfg, max_len=max_len),
                (params, _meta_inputs(cfg, shape)))
    cache = decoding.init_cache(cfg, shape, device="meta")
    tokens = _meta_inputs(cfg, shape)["tokens"]
    return (steps_lib.make_decode_step(cfg),
            (params, cache, tokens, shape.seq_len - 1))


def run_cell(arch: Union[str, ArchConfig], shape: Union[str, ShapeConfig],
             *, max_len: int = 0, verbose: bool = True) -> Dict[str, Any]:
    """The record of one cell (names, or configs such as a reduced one);
    a cell that `configs.supports` skips is recorded as skipped, a
    failing one as an error with its trace."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = get_shape(shape) if isinstance(shape, str) else shape
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": "1", "chips": 1,
           "kind": shape.kind}
    ok, why = supports(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        fn, args = build_step(cfg, shape, max_len)
        prof = op_profile.profile(fn, *args)
        if verbose:
            print(f"  memory: {prof['memory']} peak={prof['peak_bytes']}")
        rec.update(
            status="ok", count_s=round(prof["count_s"], 2),
            flops=prof["dot_flops"],
            hbm_bytes=prof["hbm_bytes"], peak_bytes=prof["peak_bytes"],
            collectives=prof["collectives"],
            collective_bytes=prof["collective_operand_bytes"],
            collective_wire_bytes=prof["collective_wire_bytes"],
            op_census=prof["op_census"], n_ops=prof["n_ops"],
            memory=prof["memory"], params=cfg.param_count(),
            active_params=cfg.active_param_count())
    except Exception as e:  # a failing cell is a bug: record and surface
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    return rec


load_results = roofline.load_results


def save_result(rec: dict) -> None:
    results = [r for r in load_results()
               if (r["arch"], r["shape"]) != (rec["arch"], rec["shape"])]
    results.append(rec)
    roofline.RESULTS.parent.mkdir(parents=True, exist_ok=True)
    roofline.RESULTS.write_text(json.dumps(results, indent=1))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already present with status=ok")
    args = ap.parse_args()

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    done = {(r["arch"], r["shape"]) for r in load_results()
            if r["status"] in ("ok", "skipped")}
    for a in archs:
        for s in shapes:
            if args.skip_done and (a, s) in done:
                print(f"[skip-done] {a} x {s}")
                continue
            print(f"=== {a} x {s} ===", flush=True)
            rec = run_cell(a, s)
            save_result(rec)
            status = rec["status"]
            extra = (f"count={rec['count_s']}s flops={rec['flops']:.3e} "
                     f"hbm={rec['hbm_bytes']:.3e}B"
                     if status == "ok" else rec.get("reason",
                                                    rec.get("error")))
            print(f"  -> {status}: {extra}", flush=True)


if __name__ == "__main__":
    main()
