"""Dry run of the port's steps: the counterpart of `repro.launch.dryrun`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape train_4k [--multi-pod | --both-meshes] [--rules tp]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --one-card \\
        --arch granite-3-2b --shape train_4k

For every (architecture x input shape) cell, `run_cell` counts one step
on meta tensors with `op_profile` and appends the reference's record
fields to `roofline.RESULTS` (``build/dryrun_torch.json``), keyed on
(arch, shape, mesh, rules), which `launch/roofline.py` reads. Nothing
runs on a device, so the CLI needs no card.

As the reference does, the CLI counts each cell per device on the
16x16 ("data", "model") mesh, or with ``--multi-pod`` the 2x16x16
("pod", "data", "model") one (``--both-meshes``: both), under the
sharding preset ``--rules`` (`distributed.meshes.PRESETS`): `run_cell`
builds the step through `launch.steps.plan` on
`launch.mesh.make_production_mesh` over meta devices and counts it per
position (`op_profile.profile_mesh`), one position of each class
(`distributed.spmd.classes`). The record is the busiest position's, the
one with the largest roofline bound (`roofline.analyze_record`), with
``"chips"`` 256 or 512, its collectives by kind and their operand and
wire bytes (`distributed.meshes`' collectives under the count); every
class's numbers and positions go beside it under ``"classes"``.
``--one-card`` counts the step of one card instead (`build_step`: the
one-card step at the shape's full global batch, ``"mesh": "1"``,
``"chips": 1``, no collectives).

Against the reference: nothing is lowered or compiled, so there are no
``lower_s``/``compile_s``: ``count_s`` is the count's host seconds (the
classes' together). RWKV-6's recurrence is a step loop of three ops a
token and a layer, so its cells walk millions of ops and take minutes.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape, supports
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import meshes as M
from repro_torch.distributed import spmd
from repro_torch.launch import op_profile, roofline
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_mesh, make_production_mesh
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


def mesh_of(mesh: Union[str, M.Mesh]) -> M.Mesh:
    """A mesh over meta devices: "16x16" (("data", "model")), "2x16x16"
    (("pod", "data", "model")), or any "AxB"/"AxBxC" of those axes; a
    `Mesh` as it is."""
    if isinstance(mesh, M.Mesh):
        return mesh
    shape = tuple(int(n) for n in mesh.split("x"))
    meta = [torch.device("meta")] * math.prod(shape)
    if mesh in ("16x16", "2x16x16"):
        return make_production_mesh(multi_pod=mesh == "2x16x16",
                                    devices=meta)
    return make_mesh(shape, ("pod", "data", "model")[-len(shape):], meta)


def mesh_name(mesh: M.Mesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


def build_mesh_step(cfg: ArchConfig, shape: ShapeConfig, mesh: M.Mesh,
                    rules: Dict[str, Any]):
    """(build, classes) of a cell over ``mesh`` under the preset
    ``rules``: ``build()`` returns the step of `steps.plan` and its
    placed meta arguments (under a count, the counted positions' pieces
    only): float32 parameters, AdamW state and the batch (train); bf16
    parameters and the prompt (prefill); bf16 parameters, the cache of
    the shape's length (int8 under serve8 and kv8) and one token a
    sequence at the last position (decode). ``classes`` groups the
    positions by their work (`spmd.classes`)."""
    step_fn, specs, pls, _out, _donate = steps_lib.plan(cfg, shape, mesh,
                                                        rules)

    def batch(spec_tree, pl_tree):
        return {k: M.place(torch.empty(s, dtype=dt, device="meta"),
                           pl_tree[k]) for k, (s, dt) in spec_tree.items()}

    step = shape.seq_len - 1
    if shape.kind == "train":
        pshapes, opt, bspec = specs
        psh, osh, bsh = pls

        def build():
            return step_fn, (M.place_tree(pshapes, psh), adamw.AdamWState(
                M.place(opt.step, osh.step), M.place_tree(opt.m, osh.m),
                M.place_tree(opt.v, osh.v)), batch(bspec, bsh))
    elif shape.kind == "prefill":
        def build():
            return step_fn, (M.place_tree(specs[0], pls[0]),
                             batch(specs[1], pls[1]))
    else:
        pshapes, cspec, (tshape, tdt), _ = specs

        def build():
            return step_fn, (M.place_tree(pshapes, pls[0]),
                             M.place_tree(cspec, pls[1]),
                             M.place(torch.empty(tshape, dtype=tdt,
                                                 device="meta"), pls[2]),
                             step)
    cp = bool(rules.get("context_parallel"))
    return build, spmd.classes(cfg, mesh, shape.kind, shape.seq_len, cp,
                               *((specs[1], pls[1]) if shape.kind == "decode"
                                 else (None, None)), step=step)


def run_cell(arch: Union[str, ArchConfig], shape: Union[str, ShapeConfig],
             *, mesh: Union[None, str, M.Mesh] = None,
             rules: Optional[Dict[str, Any]] = None,
             rules_name: str = "baseline", max_len: int = 0,
             verbose: bool = True) -> Dict[str, Any]:
    """The record of one cell (names, or configs such as a reduced one);
    a cell that `configs.supports` skips is recorded as skipped, a
    failing one as an error with its trace. ``mesh`` None counts one
    card (``max_len``: the prefill's cache slots); a mesh name or `Mesh`
    counts per position under ``rules`` (default: the preset
    ``rules_name``), the record the busiest position's."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = get_shape(shape) if isinstance(shape, str) else shape
    if mesh is None:
        rec = {"arch": cfg.name, "shape": shape.name, "mesh": "1",
               "chips": 1, "kind": shape.kind}
    else:
        mesh = mesh_of(mesh)
        rec = {"arch": cfg.name, "shape": shape.name,
               "mesh": mesh_name(mesh), "rules": rules_name,
               "chips": mesh.size, "kind": shape.kind}
    ok, why = supports(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        if mesh is None:
            fn, args = build_step(cfg, shape, max_len)
            prof = op_profile.profile(fn, *args)
            rec.update(status="ok", count_s=round(prof["count_s"], 2),
                       **_fields(prof))
        else:
            t0 = time.perf_counter()
            build, groups = build_mesh_step(
                cfg, shape, mesh, rules or steps_lib.resolve_rules(
                    rules_name))
            profs = op_profile.profile_mesh(build, mesh, groups)
            count_s = time.perf_counter() - t0
            rows = [dict(positions=p["positions"], count_s=p["count_s"],
                         **_fields(p)) for p in profs]
            busiest = max(rows, key=lambda r: _bound(dict(rec, **r)))
            prof = profs[rows.index(busiest)]
            rec.update(status="ok", count_s=round(count_s, 2),
                       **_fields(prof), position=prof["positions"][0],
                       classes=rows)
        if verbose:
            print(f"  memory: {prof['memory']} peak={prof['peak_bytes']}")
        rec.update(params=cfg.param_count(),
                   active_params=cfg.active_param_count())
    except Exception as e:  # a failing cell is a bug: record and surface
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    return rec


def _fields(prof: Dict[str, Any]) -> Dict[str, Any]:
    """A profile's numbers under the record's keys."""
    return dict(flops=prof["dot_flops"], hbm_bytes=prof["hbm_bytes"],
                peak_bytes=prof["peak_bytes"],
                collectives=prof["collectives"],
                collective_bytes=prof["collective_operand_bytes"],
                collective_wire_bytes=prof["collective_wire_bytes"],
                op_census=prof["op_census"], n_ops=prof["n_ops"],
                memory=prof["memory"])


def _bound(rec: Dict[str, Any]) -> Tuple[float, float]:
    """A class's roofline bound (its largest term at the card's
    constants), then the sum of its terms."""
    terms = (rec["flops"] / roofline.PEAK_FLOPS,
             roofline.memory_bytes(rec) / roofline.HBM_BW,
             rec["collective_bytes"] / roofline.LINK_BW)
    return max(terms), sum(terms)


load_results = roofline.load_results


def _key(rec: dict) -> tuple:
    return (rec["arch"], rec["shape"], rec["mesh"],
            rec.get("rules", "baseline"))


def save_result(rec: dict) -> None:
    """Add ``rec`` to `roofline.RESULTS` in place of the record of its
    (arch, shape, mesh, rules)."""
    results = [r for r in load_results() if _key(r) != _key(rec)]
    results.append(rec)
    roofline.RESULTS.parent.mkdir(parents=True, exist_ok=True)
    roofline.RESULTS.write_text(json.dumps(results, indent=1))


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--one-card", action="store_true",
                    help="count one card's step (no mesh, no rules)")
    ap.add_argument("--rules", default="baseline")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already present with status=ok")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    if args.one_card:
        meshes: List[Optional[str]] = [None]
    else:
        meshes = (["16x16", "2x16x16"] if args.both_meshes
                  else ["2x16x16" if args.multi_pod else "16x16"])
    done = {_key(r) for r in load_results()
            if r["status"] in ("ok", "skipped")}
    for mesh in meshes:
        where = "1" if mesh is None else mesh
        rules = "baseline" if mesh is None else args.rules
        for a in archs:
            for s in shapes:
                if args.skip_done and (a, s, where, rules) in done:
                    print(f"[skip-done] {a} x {s} @ {where}")
                    continue
                print(f"=== {a} x {s} @ {where} ({rules}) ===", flush=True)
                rec = run_cell(a, s, mesh=mesh, rules_name=rules)
                save_result(rec)
                status = rec["status"]
                extra = (f"count={rec['count_s']}s flops={rec['flops']:.3e} "
                         f"hbm={rec['hbm_bytes']:.3e}B "
                         f"coll={rec['collective_bytes']:.3e}B"
                         if status == "ok" else rec.get("reason",
                                                        rec.get("error")))
                print(f"  -> {status}: {extra}", flush=True)


if __name__ == "__main__":
    main()
