"""The port's `ArtifactStore` on the CPU: the store tests of
tests/test_pipeline_stages.py, the concurrency properties of
tests/test_artifacts_concurrent.py and the quarantine test of
tests/test_fault_dse.py, run against `repro_torch.core.artifacts`; and
the namespace that keeps the port's keys apart from the JAX package's.
"""
import os
import pickle
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import pipeline as jP
from repro.core.artifacts import ArtifactStore as JStore
from repro.core.dse import DSEResult as JDSEResult
from repro_torch.core import dataset as tds
from repro_torch.core import pipeline as P
from repro_torch.core.artifacts import (ArtifactStore, _to_numpy_tree,
                                        stable_hash)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(n_samples=120, epochs=4, dse_budget=100, hidden=32,
            n_layers=2, dse_pop=16)


def tiny_cfg(app="sobel", **kw):
    return P.PipelineConfig(app=app, **{**TINY, **kw})


# --------------------------------------------------------------------------
# keys and the two tiers
# --------------------------------------------------------------------------

def test_stable_hash_deterministic_and_order_insensitive():
    a = {"app": "sobel", "n": 5, "nested": {"x": 1.5, "y": (1, 2)}}
    b = {"nested": {"y": [1, 2], "x": 1.5}, "n": 5, "app": "sobel"}
    assert stable_hash(a) == stable_hash(b)
    assert stable_hash(a) != stable_hash({**a, "n": 6})
    # numpy and torch scalars hash as the Python number they hold
    assert stable_hash({"n": np.int64(5)}) == stable_hash({"n": 5})
    assert stable_hash({"n": torch.tensor(5)}) == stable_hash({"n": 5})


def test_stable_hash_rejects_address_bearing_values():
    class Opaque:
        pass
    with pytest.raises(TypeError, match="non-canonicalizable"):
        stable_hash({"evaluator": Opaque()})


def test_dataset_pickle_is_compact_and_round_trips():
    ds = tds.build("sobel", n_samples=100, seed=0, device="cpu")
    blob = pickle.dumps(ds)
    # constant-row adj/mask collapse: far smaller than the dense tensors
    dense = ds.adj.nbytes + ds.mask.nbytes + ds.unit_mask.nbytes
    assert len(blob) < dense
    back = pickle.loads(blob)
    for k in ("adj", "x", "mask", "unit_mask", "y", "y_raw", "crit"):
        np.testing.assert_array_equal(getattr(back, k), getattr(ds, k))
    assert back.configs == ds.configs


def test_store_disk_roundtrip_and_stats(tmp_path):
    store = ArtifactStore(str(tmp_path))
    key = store.key("dataset", {"app": "sobel", "n": 3})
    assert not store.has(key)
    built = store.get_or_build("dataset", key,
                               lambda: {"arr": np.arange(4)})
    assert store.stats.misses["dataset"] == 1
    # a fresh store on the same root serves it from disk
    store2 = ArtifactStore(str(tmp_path))
    again = store2.get_or_build("dataset", key, lambda: 1 / 0)
    np.testing.assert_array_equal(again["arr"], built["arr"])
    assert store2.stats.hits["dataset"] == 1


def test_tensor_leaves_reach_the_disk_as_numpy(tmp_path):
    """The memory tier keeps the object as given; the pickle holds NumPy
    leaves (device-independent)."""
    store = ArtifactStore(str(tmp_path))
    key = store.key("train", {"x": 1})
    obj = {"w": torch.arange(6.0).reshape(2, 3), "meta": [torch.ones(2), 7]}
    assert store.put(key, obj) is obj
    with open(tmp_path / f"{key}.pkl", "rb") as f:
        disk = pickle.load(f)
    assert isinstance(disk["w"], np.ndarray)
    np.testing.assert_array_equal(disk["w"], obj["w"].numpy())
    assert isinstance(disk["meta"][0], np.ndarray) and disk["meta"][1] == 7
    assert _to_numpy_tree("not a tree") == "not a tree"


def test_store_memory_only_never_hits_disk(tmp_path):
    store = ArtifactStore(str(tmp_path))
    key = store.key("engine", {"x": 1})
    store.get_or_build("engine", key, lambda: object(), memory_only=True)
    assert list(tmp_path.glob("*.pkl")) == []
    assert store.has(key)                     # memory tier still serves it


def test_store_key_spec_sensitivity():
    c1, c2 = tiny_cfg(), tiny_cfg(dse_budget=999)
    # dse_budget is a search-stage knob: dataset/train keys must not move
    assert ArtifactStore.key("dataset", P._dataset_spec(c1)) == \
        ArtifactStore.key("dataset", P._dataset_spec(c2))
    assert ArtifactStore.key("train", P._train_spec(c1)) == \
        ArtifactStore.key("train", P._train_spec(c2))
    assert ArtifactStore.key("search", P._search_spec(c1)) != \
        ArtifactStore.key("search", P._search_spec(c2))
    # n_samples invalidates everything downstream of the dataset
    c3 = tiny_cfg(n_samples=77)
    assert ArtifactStore.key("dataset", P._dataset_spec(c1)) != \
        ArtifactStore.key("dataset", P._dataset_spec(c3))
    assert ArtifactStore.key("train", P._train_spec(c1)) != \
        ArtifactStore.key("train", P._train_spec(c3))


def test_store_evict_keys_and_checkpoint_gc(tmp_path):
    store = ArtifactStore(str(tmp_path))
    old = store.key("search_ckpt", {"run": 1})
    new = store.key("search_ckpt", {"run": 2})
    other = store.key("search", {"run": 1})
    for k in (old, new, other):
        store.put(k, {"k": k})
    store._mtimes[old] -= 100.0               # last written 100 s ago
    assert store.gc_checkpoints(50.0) == (old,)
    assert set(store.keys()) == {new, other}
    # a later process sees only the disk tier: age from the file's mtime
    p = tmp_path / f"{new}.pkl"
    os.utime(p, (p.stat().st_atime, p.stat().st_mtime - 100.0))
    fresh = ArtifactStore(str(tmp_path))
    assert fresh.gc_checkpoints(50.0) == (new,)
    fresh.evict(other)
    assert fresh.keys() == () and list(tmp_path.glob("*.pkl")) == []


# --------------------------------------------------------------------------
# the namespace: the port's keys never equal the JAX package's
# --------------------------------------------------------------------------

_OPEN_AS_PORT = """
import sys
from repro_torch.core import pipeline as P
from repro_torch.core.artifacts import ArtifactStore
cfg = P.PipelineConfig(app="sobel", n_samples=120, epochs=4, dse_budget=100,
                       hidden=32, n_layers=2, dse_pop=16)
store = ArtifactStore(sys.argv[1])
specs = {"dataset": P._dataset_spec(cfg), "train": P._train_spec(cfg),
         "search": P._search_spec(cfg)}
for stage, spec in specs.items():
    key = store.key(stage, spec)
    assert not store.has(key), key
    assert store.get_or_build(stage, key, lambda: stage) == stage
assert store.stats.misses == {s: 1 for s in specs}, store.stats.misses
assert not store.stats.quarantines
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len(store.keys()))
"""


def test_port_keys_differ_from_the_reference_and_miss_its_pickles(tmp_path):
    """For the same stage and spec the two packages' keys differ, and a
    port store opened (in a fresh interpreter) on a directory the JAX
    package's store wrote finds none of its pickles: every stage misses,
    nothing is quarantined, and neither jax nor repro is imported."""
    cfg_t = tiny_cfg()
    cfg_j = jP.PipelineConfig(app="sobel", **TINY)
    specs = {"dataset": (jP._dataset_spec(cfg_j), P._dataset_spec(cfg_t)),
             "train": (jP._train_spec(cfg_j), P._train_spec(cfg_t)),
             "search": (jP._search_spec(cfg_j), P._search_spec(cfg_t))}
    jstore = JStore(str(tmp_path))
    for stage, (jspec, tspec) in specs.items():
        assert ArtifactStore.key(stage, jspec) != JStore.key(stage, jspec)
        # a reference artifact, whose unpickling would import repro
        jstore.put(JStore.key(stage, jspec),
                   JDSEResult([(0,)], np.zeros((1, 4)), 1))
    # the dataset specs are equal: only the namespace keeps the keys apart
    assert specs["dataset"][0] == specs["dataset"][1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _OPEN_AS_PORT, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    # the reference's three pickles stay; the port wrote three of its own
    assert int(r.stdout.strip().splitlines()[-1]) == 6
    assert len(list(tmp_path.glob("*.pkl"))) == 6


# --------------------------------------------------------------------------
# concurrency (tests/test_artifacts_concurrent.py on the port's store)
# --------------------------------------------------------------------------

def _hammer(n_threads, fn):
    """Run `fn(i)` from n_threads threads through a start barrier;
    re-raises the first worker exception."""
    barrier = threading.Barrier(n_threads)
    errors = []

    def work(i):
        try:
            barrier.wait()
            fn(i)
        except BaseException as e:             # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


@settings(max_examples=10, deadline=None)
@given(st.integers(2, 12), st.integers(1, 4))
def test_same_key_get_or_build_builds_once(n_threads, repeats):
    """All racers on one key: exactly one build; hits+misses == calls."""
    store = ArtifactStore(None)
    built = []

    def build():
        built.append(1)
        return {"payload": 42}

    def racer(i):
        for _ in range(repeats):
            got = store.get_or_build("stage", "k", build)
            assert got == {"payload": 42}

    _hammer(n_threads, racer)
    assert len(built) == 1
    st_ = store.stats.as_dict()
    assert st_["misses"].get("stage", 0) == 1
    assert st_["hits"].get("stage", 0) + 1 == n_threads * repeats


@settings(max_examples=6, deadline=None)
@given(st.integers(2, 8))
def test_disjoint_keys_fully_parallel_exact_counters(n_threads):
    """Disjoint writers + readers: every key built exactly once, every
    artifact retrievable, per-stage counters sum to the call count."""
    store = ArtifactStore(None)
    builds = {}
    lock = threading.Lock()

    def racer(i):
        key = f"k{i}"

        def build():
            with lock:
                builds[key] = builds.get(key, 0) + 1
            return np.full(16, i)

        for _ in range(5):
            got = store.get_or_build(f"s{i}", key, build)
            assert np.array_equal(got, np.full(16, i))

    _hammer(n_threads, racer)
    assert builds == {f"k{i}": 1 for i in range(n_threads)}
    st_ = store.stats.as_dict()
    for i in range(n_threads):
        assert st_["misses"][f"s{i}"] == 1
        assert st_["hits"][f"s{i}"] == 4
    assert sorted(store.keys()) == sorted(f"k{i}" for i in range(n_threads))


@settings(max_examples=5, deadline=None)
@given(st.integers(2, 8))
def test_concurrent_same_key_writers_no_torn_pickle(n_threads):
    """Same-key overwriters racing readers on the disk tier: every read
    (in-process and raw off-disk) sees one writer's complete array."""
    with tempfile.TemporaryDirectory() as root:
        store = ArtifactStore(root)
        payloads = {i: np.full(4096, i, np.int64) for i in range(n_threads)}
        stop = threading.Event()
        seen = []

        def racer(i):
            if i == 0:        # dedicated reader thread
                while not stop.is_set():
                    try:
                        obj = store.get("k")
                    except KeyError:
                        continue
                    assert len(set(obj.tolist())) == 1    # untorn
                    seen.append(int(obj[0]))
                return
            for _ in range(10):
                store.put("k", payloads[i])
                with store._mem_lock:     # force the next get off disk
                    store._memory.pop("k", None)
            stop.set()                    # first finished writer frees reader

        _hammer(n_threads, racer)
        stop.set()
        with open(store._path("k"), "rb") as f:
            final = pickle.load(f)
        assert int(final[0]) in payloads and len(set(final.tolist())) == 1
        assert all(v in payloads for v in seen)


def test_evict_races_get_or_build():
    """evict vs get_or_build on one key never corrupts state: afterwards
    the key either exists with the built value or is absent."""
    store = ArtifactStore(None)

    def racer(i):
        for _ in range(50):
            if i % 2:
                store.get_or_build("s", "k", lambda: "value")
            else:
                store.evict("k")

    _hammer(8, racer)
    if store.has("k"):
        assert store.get("k") == "value"
    st_ = store.stats.as_dict()
    n_calls = 4 * 50
    assert st_["hits"].get("s", 0) + st_["misses"].get("s", 0) == n_calls


# --------------------------------------------------------------------------
# torn pickles are quarantined misses (tests/test_fault_dse.py)
# --------------------------------------------------------------------------

def test_store_quarantines_corrupt_pickle_and_rebuilds(tmp_path):
    root = str(tmp_path)
    key = ArtifactStore.key("dataset", {"x": 1})
    ArtifactStore(root).put(key, {"v": 42})

    (tmp_path / f"{key}.pkl").write_bytes(b"\x80\x04 torn mid-write")
    s2 = ArtifactStore(root)              # fresh process: no memory tier
    with pytest.raises(KeyError):
        s2.get(key)
    assert (tmp_path / f"{key}.pkl.corrupt").exists()
    assert not (tmp_path / f"{key}.pkl").exists()
    assert s2.stats.as_dict()["quarantines"] == [key]

    # get_or_build sees a plain miss and rebuilds the slot
    built = s2.get_or_build("dataset", key, lambda: {"v": 43})
    assert built == {"v": 43} and s2.get(key) == {"v": 43}
    assert s2.stats.misses == {"dataset": 1}

    # a second corruption parks beside the first with a numeric suffix
    (tmp_path / f"{key}.pkl").write_bytes(b"also garbage")
    s3 = ArtifactStore(root)
    with pytest.raises(KeyError):
        s3.get(key)
    assert (tmp_path / f"{key}.pkl.corrupt1").exists()
