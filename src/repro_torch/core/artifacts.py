"""Content-addressed artifact store for the staged pipeline.

The port's copy of `repro.core.artifacts`. The ApproxPilot flow (Fig. 1)
produces a chain of expensive artifacts — pruned library, labeled
dataset, trained surrogate params, inference engine, Pareto front — and
each stage gets a content-addressed cache slot:

* **Keys** are a stable hash of the *governing config slice*: the stage
  name plus exactly the fields of `PipelineConfig` (and upstream keys)
  that determine the stage's output. The hash also covers the package
  name (`NAMESPACE`), so this store's keys never equal the JAX package's
  for the same spec: a port store pointed at a directory the reference
  wrote finds none of its pickles (which would import the JAX package
  when unpickled) and rebuilds.
* **Disk tier** (`root` given): picklable artifacts (datasets, trained
  params as NumPy, DSE results) persist under ``<root>/<key>.pkl`` and
  survive the process.
* **Memory tier** (always on): every artifact, including those bound to
  a device (the app context's tensors, the `SurrogateEngine`), is
  memoized in-process. A store with ``root=None`` is memory-only.
* **Stats** (`StoreStats`): per-stage hit/miss counters and the keys of
  quarantined pickles.

Tensor leaves are converted to NumPy before they reach the disk tier
(`_to_numpy_tree`), so cached artifacts are device-independent.

The reference's `enable_compilation_cache` and the store's
``compilation_cache_dir`` are left out: they point JAX's persistent
compilation cache at the store, and the port compiles nothing per shape
(its CUDA kernels are built once per source, `repro_torch.kernels.build`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

# hashed into every key: the JAX package's keys for the same spec differ
NAMESPACE = "repro_torch"


def _canonical(obj: Any) -> Any:
    """Reduce an object to a deterministic, JSON-serializable structure."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__dc__": type(obj).__name__,
                **{f.name: _canonical(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict):
        return {str(k): _canonical(v) for k, v in sorted(obj.items(),
                                                         key=lambda kv:
                                                         str(kv[0]))}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "item"):                     # numpy / torch scalars
        return obj.item()
    # refuse rather than fall back to repr(): default reprs embed memory
    # addresses, which would silently give every process a different key
    raise TypeError(
        f"cache-key spec contains a non-canonicalizable value of type "
        f"{type(obj).__name__}: {obj!r}")


def stable_hash(obj: Any, n_hex: int = 16) -> str:
    """Deterministic content hash of a (nested) config structure."""
    blob = json.dumps(_canonical(obj), sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()[:n_hex]


@dataclass
class StoreStats:
    """Per-stage cache counters (`hits[stage]`, `misses[stage]`), the
    ordered event log, and the keys whose disk pickle was found corrupt
    and renamed aside (``quarantines``). Thread-safe."""
    hits: Dict[str, int] = field(default_factory=dict)
    misses: Dict[str, int] = field(default_factory=dict)
    events: list = field(default_factory=list)   # (stage, "hit"|"miss", key)
    quarantines: list = field(default_factory=list)   # corrupt-pickle keys

    def __post_init__(self):
        self._lock = threading.Lock()

    def record(self, stage: str, hit: bool, key: str) -> None:
        with self._lock:
            d = self.hits if hit else self.misses
            d[stage] = d.get(stage, 0) + 1
            self.events.append((stage, "hit" if hit else "miss", key))

    def record_quarantine(self, key: str) -> None:
        with self._lock:
            self.quarantines.append(key)

    def as_dict(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {"hits": dict(self.hits), "misses": dict(self.misses),
                    "quarantines": list(self.quarantines)}


def _to_numpy_tree(obj: Any) -> Any:
    """Tensor leaves -> NumPy (device-independent pickles)."""
    import torch
    from torch.utils import _pytree as pytree

    def one(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else x
    return pytree.tree_map(one, obj)


class ArtifactStore:
    """Two-tier (memory + optional disk) content-addressed artifact cache.

    >>> store = ArtifactStore("/tmp/approxpilot-cache")
    >>> key = store.key("dataset", {"app": "sobel", "n_samples": 500})
    >>> ds = store.get_or_build("dataset", key, lambda: expensive_build())

    ``get_or_build`` is the entry point the pipeline stages use; the
    lower-level ``get``/``put``/``has`` serve tools and tests.
    """

    def __init__(self, root: Optional[str] = None):
        self.root = Path(root) if root is not None else None
        if self.root is not None:
            self.root.mkdir(parents=True, exist_ok=True)
        self._memory: Dict[str, Any] = {}
        # last-write wall-clock timestamp per memory-tier key (the disk
        # mtimes' time domain), for `gc_checkpoints`
        self._mtimes: Dict[str, float] = {}
        self.stats = StoreStats()
        # `_mem_lock` guards the memory tier; `_key_locks` serializes the
        # builds of each key, so racing `get_or_build` calls on one key
        # make one build (the rest are hits) while disjoint keys run in
        # parallel. Disk writes go through a tempfile and `os.replace`, so
        # a reader sees the old or the new whole pickle, never a torn one.
        self._mem_lock = threading.Lock()
        self._key_locks: Dict[str, threading.RLock] = {}

    def _key_lock(self, key: str) -> threading.RLock:
        with self._mem_lock:
            lock = self._key_locks.get(key)
            if lock is None:
                lock = self._key_locks[key] = threading.RLock()
            return lock

    # -- keys --------------------------------------------------------------

    @staticmethod
    def key(stage: str, spec: Any) -> str:
        """``<stage>-<hash(namespace, spec)>``: readable prefix,
        content-hashed body."""
        return f"{stage}-{stable_hash({'namespace': NAMESPACE, 'spec': spec})}"

    # -- low-level ---------------------------------------------------------

    def _path(self, key: str) -> Optional[Path]:
        return self.root / f"{key}.pkl" if self.root is not None else None

    def has(self, key: str) -> bool:
        with self._mem_lock:
            if key in self._memory:
                return True
        p = self._path(key)
        return p is not None and p.exists()

    def get(self, key: str) -> Any:
        with self._mem_lock:
            if key in self._memory:
                return self._memory[key]
        p = self._path(key)
        if p is not None and p.exists():
            try:
                with open(p, "rb") as f:
                    obj = pickle.load(f)
            except Exception:
                # a corrupt pickle (external damage: the writer is
                # atomic) is set aside and reported as a miss
                self._quarantine(key, p)
                raise KeyError(key) from None
            with self._mem_lock:
                # first load wins: every caller then shares one object
                obj = self._memory.setdefault(key, obj)
            return obj
        raise KeyError(key)

    def _quarantine(self, key: str, p: Path) -> None:
        """Rename a corrupt disk pickle to ``<key>.pkl.corrupt`` (numeric
        suffix if one is already parked) and count it in the stats."""
        q = Path(f"{p}.corrupt")
        i = 0
        while q.exists():
            i += 1
            q = Path(f"{p}.corrupt{i}")
        try:
            os.replace(p, q)
        except OSError:
            return            # a concurrent reader already quarantined it
        self.stats.record_quarantine(key)

    def put(self, key: str, obj: Any, *, memory_only: bool = False) -> Any:
        with self._key_lock(key):
            with self._mem_lock:
                self._memory[key] = obj
                self._mtimes[key] = time.time()
            p = self._path(key)
            if p is not None and not memory_only:
                disk_obj = _to_numpy_tree(obj)
                fd, tmp = tempfile.mkstemp(dir=str(self.root),
                                           prefix=f".{key}.")
                try:
                    with os.fdopen(fd, "wb") as f:
                        pickle.dump(disk_obj, f, protocol=4)
                    os.replace(tmp, p)
                except BaseException:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                    raise
        return obj

    def evict(self, key: str) -> None:
        with self._key_lock(key):
            with self._mem_lock:
                self._memory.pop(key, None)
                self._mtimes.pop(key, None)
            p = self._path(key)
            if p is not None and p.exists():
                p.unlink()

    def keys(self) -> Tuple[str, ...]:
        disk = ()
        if self.root is not None:
            disk = tuple(p.stem for p in self.root.glob("*.pkl"))
        with self._mem_lock:
            mem = set(self._memory)
        return tuple(sorted(mem | set(disk)))

    def gc_checkpoints(self, max_age_s: float,
                       prefix: str = "search_ckpt") -> Tuple[str, ...]:
        """Evict ``search_ckpt`` entries older than ``max_age_s`` seconds;
        returns the evicted keys.

        A finished checkpointed search evicts its own checkpoint
        (`pipeline.stage_search`), and a running one re-puts its key every
        ``checkpoint_every`` generations, so a key whose last write is
        older than ``max_age_s`` belongs to a crashed or abandoned search.
        Age comes from the store's own put timestamps, or the pickle's
        mtime for disk entries of an earlier process. Called by
        `repro_torch.launch.serve.EvalService.health`.
        """
        now = time.time()
        stale = []
        for key in self.keys():
            if not key.startswith(f"{prefix}-"):
                continue
            with self._mem_lock:
                ts = self._mtimes.get(key)
            if ts is None:
                p = self._path(key)
                try:
                    ts = p.stat().st_mtime if p is not None else None
                except OSError:
                    continue      # raced with an evict: already gone
            if ts is None or now - ts > max_age_s:
                self.evict(key)
                stale.append(key)
        return tuple(stale)

    # -- the stage entry point --------------------------------------------

    def get_or_build(self, stage: str, key: str, build: Callable[[], Any],
                     *, memory_only: bool = False) -> Any:
        """Return the cached artifact for ``key``, or build and cache it.

        ``memory_only`` keeps device-bound artifacts out of the disk tier.
        Callers racing on one key serialize on its lock, so one of them
        builds (the sole miss) and the rest are hits: hits and misses sum
        to the number of calls. A corrupt disk pickle is quarantined by
        `get` and counts as a miss, so it costs a rebuild, never an
        exception or a wrong artifact."""
        with self._key_lock(key):
            try:
                obj = self.get(key)
            except KeyError:
                self.stats.record(stage, False, key)
                return self.put(key, build(), memory_only=memory_only)
            self.stats.record(stage, True, key)
            return obj
