"""Fault-tolerant checkpointing of trees of tensors.

The port of `repro.checkpointing`, with the reference's on-disk layout,
so that either package restores what the other saved:

    <dir>/step_<n>/
        manifest.json      step, leaf count, each leaf's shape and dtype
        arr_<i>.npy        one file per leaf, in the reference's order
        .complete          commit marker

Leaves are taken in ``jax.tree`` order: dict keys sorted, lists and
tuples (an `AdamWState` too) in field order. bfloat16 leaves are stored
as their uint16 bits and float8 leaves as their uint8 bits (``np.load``
knows neither type); the manifest names the real type.

- Atomic commits: a step is written into a temporary directory and
  renamed into place, and only a directory with ``.complete`` counts, so
  a crash mid-write never spoils the latest checkpoint.
- `AsyncCheckpointer` writes on a background thread, at most one save in
  flight. Its ``save`` copies every leaf to the host before it returns:
  on the CPU ``Tensor.numpy()`` shares memory with the tensor, and the
  next in-place optimizer update would change a snapshot still being
  written.
- Retention keeps the last ``keep_last`` steps.
- `restore` rebuilds the caller's tree on the caller's device.
- Elastic restore: a leaf placed on a mesh
  (`distributed.meshes.ShardedTensor`) is saved as its whole logical
  array, and `restore(..., shardings=)` places each leaf by the current
  mesh's `Placement`s, so a run may restart on another mesh shape or
  device count.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.distributed import meshes as M
from repro_torch.models.layers import tree_leaves

# types NumPy cannot hold: stored as integer bits of the same width
_BITS = {"bfloat16": (np.uint16, torch.int16),
         "float8_e4m3fn": (np.uint8, torch.uint8),
         "float8_e5m2": (np.uint8, torch.uint8)}


def _unflatten(like, it):
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, it) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, it) for v in like)
    return None if like is None else next(it)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array written to disk, the leaf's dtype name)."""
    if M.is_placed(leaf):
        leaf = leaf.gather("cpu")
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu()
    name = str(t.dtype).replace("torch.", "")
    if name in _BITS:
        np_bits, torch_bits = _BITS[name]
        return t.view(torch_bits).numpy().view(np_bits), name
    return t.numpy(), name


def _from_numpy(arr: np.ndarray, name: str) -> torch.Tensor:
    # ascontiguousarray makes a 0-d array 1-d: reshape back
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if name in _BITS:
        np_bits, torch_bits = _BITS[name]
        bits = arr.view(np_bits)
        if torch_bits == torch.int16:
            bits = bits.view(np.int16)
        return torch.from_numpy(bits).view(getattr(torch, name))
    return torch.from_numpy(arr)


def save(ckpt_dir: str | Path, step: int, tree, keep_last: int = 3) -> Path:
    """Write ``tree`` as step ``step`` (tmp dir, marker, atomic rename),
    then drop all but the last ``keep_last`` steps."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp_step_{step}_{os.getpid()}"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    leaves = tree_leaves(tree)
    manifest = {"step": step, "treedef": f"{len(leaves)} leaves",
                "n_leaves": len(leaves), "time": time.time(),
                "leaves": []}
    for i, leaf in enumerate(leaves):
        arr, name = _to_numpy(leaf)
        np.save(tmp / f"arr_{i}.npy", arr)
        manifest["leaves"].append({"shape": list(arr.shape),
                                   "dtype": name})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / ".complete").touch()
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic commit
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: Path, keep_last: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep_last]:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)


def all_steps(ckpt_dir: str | Path) -> list:
    """The committed steps, ascending."""
    ckpt_dir = Path(ckpt_dir)
    out = []
    if not ckpt_dir.exists():
        return out
    for p in ckpt_dir.iterdir():
        if p.name.startswith("step_") and (p / ".complete").exists():
            out.append(int(p.name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str | Path, tree_like, step: Optional[int] = None,
            device: DeviceLike = None, shardings=None):
    """(the tree saved at ``step`` (the latest if None) in the structure
    of ``tree_like``, the step). With ``shardings`` (a tree of
    `Placement`s in that structure) each leaf is placed by its own
    (`meshes.place`); else it goes to ``device`` if given, else to the
    device of its leaf in ``tree_like`` (the CPU for a non-tensor
    leaf)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step}"
    if not (d / ".complete").exists():
        raise FileNotFoundError(f"checkpoint {d} incomplete")
    manifest = json.loads((d / "manifest.json").read_text())
    like = tree_leaves(tree_like)
    if manifest["n_leaves"] != len(like):
        raise ValueError(f"leaf count mismatch: {manifest['n_leaves']} "
                         f"saved, {len(like)} in the tree")
    pls = tree_leaves(shardings) if shardings is not None else None
    out = []
    for i, leaf in enumerate(like):
        t = _from_numpy(np.load(d / f"arr_{i}.npy"),
                        manifest["leaves"][i]["dtype"])
        if pls is not None:
            out.append(M.place(t, pls[i]))
            continue
        if M.is_placed(leaf):
            leaf = leaf.pieces[0]
        dev = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        out.append(t.to(dev))
    return _unflatten(tree_like, iter(out)), step


class AsyncCheckpointer:
    """Background-thread saver with a bounded in-flight queue (depth 1)."""

    def __init__(self, ckpt_dir: str | Path, keep_last: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep_last = keep_last
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree = item
            try:
                save(self.ckpt_dir, step, tree, self.keep_last)
            except BaseException as e:     # surfaced on next save/close
                self._err = e
            finally:
                self._q.task_done()

    def save(self, step: int, tree) -> None:
        """Queue ``tree`` as step ``step``: every tensor leaf is copied to
        the host now (module docstring); blocks while a save is in
        flight."""
        if self._err:
            raise self._err
        host = _unflatten(tree, iter(
            [x.gather("cpu") if M.is_placed(x)
             else x.detach().to("cpu", copy=True)
             if isinstance(x, torch.Tensor) else x
             for x in tree_leaves(tree)]))
        self._q.put((step, host))          # blocks if a save is in flight

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=10)
