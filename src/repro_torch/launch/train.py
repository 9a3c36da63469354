"""Fault-tolerant LM training loop, on one card or over a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
        --reduced --steps 30 --device cpu

The port of `repro.launch.train`: seeded float32 master parameters and
AdamW state (`build_state`), `launch.steps.make_train_step` over
`data.tokens.TokenPipeline` batches, restore on start from the latest
checkpoint, asynchronous checkpoints every ``ckpt_every`` steps,
injected faults (`distributed.fault.FaultInjector`: host crash, stall,
corrupted batch), straggler detection (`HealthMonitor`), the non-finite
loss message, and restart by recursion after a `HostFailure`. The run
takes a ``mesh`` (default: `default_mesh`); the result's ``"mesh"`` is
its
``tuple(mesh.shape.items())``. On a mesh of one position the state is
plain tensors on that device; on a larger mesh it is placed by the
storage rules (`meshes.param_shardings`), the step runs over the mesh
(`steps.make_train_step(grad_shardings=...)`; the families that
`distributed.spmd.supports`),
and checkpoints hold whole logical arrays, so a restart may come back
on another mesh (the reference's elastic restart) and continue from the
checkpoint. Without ``--device`` it runs on the card and raises on a
host without one.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import checkpointing as ckpt_lib
from repro_torch import device as device_lib
from repro_torch.configs import ARCHS, REDUCED_ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import DeviceLike
from repro_torch.distributed.fault import (FaultInjector, HealthMonitor,
                                           HostFailure)
from repro_torch.distributed import meshes as M
from repro_torch.distributed import spmd
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import transformer
from repro_torch.models.layers import params_from_numpy
from repro_torch.optim import adamw


def state_shardings(cfg, mesh: M.Mesh, rules=None):
    """(parameter placements, `AdamWState` placements) of the training
    state on ``mesh`` under the storage ``rules`` (default
    `meshes.BASE_RULES`), the reference's ``build_state`` shardings."""
    table = transformer.build_param_table(cfg)
    psh = M.param_shardings(mesh, table.logical_axes(), table.shapes(),
                            rules or M.BASE_RULES,
                            head_dim=cfg.resolved_head_dim)
    return psh, adamw.AdamWState(step=M.replicated(mesh), m=psh, v=psh)


def default_mesh(cfg, device: DeviceLike = None) -> M.Mesh:
    """The mesh `train` runs on when it is given none: `make_mesh_for`
    over every local device of ``device``'s type where `distributed.spmd`
    runs ``cfg`` over a mesh (`spmd.supports`: every family of
    `configs`); else, and whenever ``device`` names one device by its
    index (``cuda:3``), a mesh of one position on ``device``."""
    dev = device_lib.resolve(device)
    local = device_lib.local_devices(dev.type)
    named = device is not None and torch.device(device).index is not None
    if named or len(local) < 2 or not spmd.supports(cfg):
        return make_mesh_for(1, devices=[dev])
    return make_mesh_for(len(local), devices=local)


def build_state(cfg, device: DeviceLike = None, init_params=None,
                mesh: Optional[M.Mesh] = None, rules=None):
    """(float32 master parameters, `adamw.init` state) on ``device``: the
    parameters from a ``torch.Generator`` on the device seeded with 0 (the
    reference seeds its key with 0), or, given ``init_params`` (a tree of
    NumPy arrays, such as the reference's parameters after
    ``np.asarray``), those cast to float32. With ``mesh`` of more than
    one position they are drawn on its first device and placed by
    `state_shardings` (``rules``), and the state is placed."""
    if mesh is not None and mesh.size > 1:
        device = mesh.device_list()[0]
    dev = device_lib.resolve(device)
    if init_params is not None:
        params = params_from_numpy(init_params, dev, dtype=torch.float32)
    else:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = transformer.build_param_table(cfg).init(
            gen, device=dev, dtype=torch.float32)
    if mesh is not None and mesh.size > 1:
        psh, _ = state_shardings(cfg, mesh, rules)
        params = M.place_tree(params, psh)
    return params, steps_lib.init_opt(params)


def batch_on(batch, extra_specs, dev):
    """A `TokenPipeline` batch as tensors on ``dev`` in the specs' types
    (tokens and labels int32)."""
    out = {}
    for k, v in batch.items():
        dt = extra_specs[k][1] if k in extra_specs else torch.int32
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(dev, dt)
    return out


def train(cfg, shape: ShapeConfig, steps: int, ckpt_dir: Optional[str],
          injector: Optional[FaultInjector] = None, ckpt_every: int = 10,
          log_every: int = 10, restarts_left: int = 3,
          device: DeviceLike = None, mesh: Optional[M.Mesh] = None):
    """Run ``steps`` training steps; returns {"losses", "stragglers",
    "final_step", "mesh", "params", "opt"}. ``params`` and ``opt`` are the
    final state (the reference keeps them inside the function), placed on
    ``mesh`` when it has more than one position; ``mesh`` defaults to
    `default_mesh` (``device``'s local devices, or ``device`` alone). Each
    run, and each restart, starts from `build_state` and then restores
    the latest checkpoint of ``ckpt_dir`` onto its own mesh, so a run that
    crashed and restarted, on this mesh or another, ends where an
    uninterrupted one does."""
    if mesh is None:
        mesh = default_mesh(cfg, device)
    placed = mesh.size > 1
    if placed:
        spmd.check_supported(cfg, mesh)
    dev = mesh.device_list()[0]
    params, opt = build_state(cfg, dev, mesh=mesh)
    psh, osh = state_shardings(cfg, mesh) if placed else (None, None)

    pipe = TokenPipeline(cfg.vocab_size, shape.seq_len, shape.global_batch)
    extra_specs = {k: v for k, v in steps_lib.input_specs(cfg, shape).items()
                   if k not in ("tokens", "labels")}

    start_step = 0
    ckpter = None
    if ckpt_dir:
        ckpter = ckpt_lib.AsyncCheckpointer(ckpt_dir)
        latest = ckpt_lib.latest_step(ckpt_dir)
        if latest is not None:
            (params, opt), start_step = ckpt_lib.restore(
                ckpt_dir, (params, opt), device=dev,
                shardings=(psh, osh) if placed else None)
            start_step += 1
            print(f"[restore] resumed from step {start_step - 1}")

    step_fn = steps_lib.make_train_step(cfg, shape, grad_shardings=psh)
    monitor = HealthMonitor()
    losses = []
    step = start_step
    try:
        while step < steps:
            t0 = time.time()
            if injector:
                injector.check(step)   # stalls count into step time
            batch = pipe.batch_at(step, extra_specs)
            if injector and injector.corrupt(step):
                batch["tokens"] = np.full_like(batch["tokens"],
                                               cfg.vocab_size - 1)
                batch["labels"] = np.full_like(batch["labels"], -1)
            params, opt, metrics = step_fn(
                params, opt, batch if placed
                else batch_on(batch, extra_specs, dev))
            loss = float(metrics["loss"])
            dt = time.time() - t0
            straggler = monitor.record(step, dt)
            if not np.isfinite(loss):
                print(f"[nan-skip] step {step}: non-finite loss, "
                      f"skipping update")
            if straggler:
                print(f"[straggler] step {step}: {dt:.3f}s "
                      f"(ewma {monitor.ewma:.3f}s) — re-dispatched")
            losses.append(loss)
            if ckpter and (step + 1) % ckpt_every == 0:
                ckpter.save(step, (params, opt))
            if log_every and step % log_every == 0:
                print(f"step {step}: loss={loss:.4f} ({dt * 1e3:.0f} ms)")
            step += 1
    except HostFailure as e:
        print(f"[failure] {e}; restarting from latest checkpoint "
              f"({restarts_left} restarts left)")
        if ckpter:
            ckpter.close()
        if restarts_left <= 0 or not ckpt_dir:
            raise
        return train(cfg, shape, steps, ckpt_dir, injector=injector,
                     ckpt_every=ckpt_every, log_every=log_every,
                     restarts_left=restarts_left - 1, device=device,
                     mesh=mesh)
    if ckpter:
        ckpter.save(steps - 1, (params, opt))
        ckpter.close()
    return {"losses": losses, "stragglers": monitor.stragglers,
            "final_step": step, "mesh": tuple(mesh.shape.items()),
            "params": params, "opt": opt}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--crash-at", type=int, nargs="*", default=[])
    ap.add_argument("--stall-at", type=int, nargs="*", default=[])
    ap.add_argument("--nan-at", type=int, nargs="*", default=[])
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain PyTorch path (default: the "
                         "card)")
    args = ap.parse_args(argv)

    cfg = (REDUCED_ARCHS if args.reduced else ARCHS)[args.arch]
    shape = ShapeConfig("custom", args.seq, args.batch, "train",
                        grad_accum=args.accum)
    inj = FaultInjector(crash_at=args.crash_at, stall_at=args.stall_at,
                        nan_at=args.nan_at) if (
        args.crash_at or args.stall_at or args.nan_at) else None
    out = train(cfg, shape, args.steps, args.ckpt, injector=inj,
                ckpt_every=args.ckpt_every, device=args.device)
    print(f"done: {out['final_step']} steps, "
          f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}, "
          f"stragglers={out['stragglers']}")


if __name__ == "__main__":
    main()
