"""Fault-tolerant LM training loop on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
        --reduced --steps 30 --device cpu

The port of `repro.launch.train`: seeded float32 master parameters and
AdamW state (`build_state`), `launch.steps.make_train_step` over
`data.tokens.TokenPipeline` batches, restore on start from the latest
checkpoint, asynchronous checkpoints every ``ckpt_every`` steps,
injected faults (`distributed.fault.FaultInjector`: host crash, stall,
corrupted batch), straggler detection (`HealthMonitor`), the non-finite
loss message, and restart by recursion after a `HostFailure`. There is
no mesh: one card (or the CPU) holds the whole state, and the result's
``"mesh"`` reads ``(("data", 1),)``. The reference's elastic restart
onto another mesh is multi-card work (ROADMAP queue 1). Without
``--device`` it runs on the card and raises on a host without one.
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
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer
from repro_torch.models.layers import params_from_numpy
from repro_torch.optim import adamw


def build_state(cfg, device: DeviceLike = None, init_params=None):
    """(float32 master parameters, `adamw.init` state) on ``device``: the
    parameters from a ``torch.Generator`` on the device seeded with 0 (the
    reference seeds its key with 0), or, given ``init_params`` (a tree of
    NumPy arrays, such as the reference's parameters after
    ``np.asarray``), those cast to float32."""
    dev = device_lib.resolve(device)
    if init_params is not None:
        params = params_from_numpy(init_params, dev, dtype=torch.float32)
    else:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = transformer.build_param_table(cfg).init(
            gen, device=dev, dtype=torch.float32)
    return params, adamw.init(params)


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
          device: DeviceLike = None):
    """Run ``steps`` training steps; returns {"losses", "stragglers",
    "final_step", "mesh", "params", "opt"}. ``params`` and ``opt`` are the
    final state (the reference keeps them inside the function); ``mesh``
    is ``(("data", 1),)``. Each run, and each restart, starts from
    `build_state` and then restores the latest checkpoint of
    ``ckpt_dir``, so a run that crashed and restarted ends where an
    uninterrupted one does."""
    dev = device_lib.resolve(device)
    params, opt = build_state(cfg, dev)

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
                ckpt_dir, (params, opt), device=dev)
            start_step += 1
            print(f"[restore] resumed from step {start_step - 1}")

    step_fn = steps_lib.make_train_step(cfg, shape)
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
                params, opt, batch_on(batch, extra_specs, dev))
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
                     restarts_left=restarts_left - 1, device=dev)
    if ckpter:
        ckpter.save(steps - 1, (params, opt))
        ckpter.close()
    return {"losses": losses, "stragglers": monitor.stragglers,
            "final_step": step, "mesh": (("data", 1),),
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
