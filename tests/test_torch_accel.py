"""The port's accel modules against the JAX package: unit truth tables,
the batched adder/subtractor, library metrics and pruning, the batched
synthesis oracle and the config-batched functional model, all on the CPU
with the same NumPy-made inputs on both sides."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.accel import apps as japps
from repro.accel import batch_oracle as jbo
from repro.accel import library as jlib
from repro.accel import units as junits
from repro.core import pruning as jpruning
from repro_torch.accel import apps as tapps
from repro_torch.accel import batch_oracle as tbo
from repro_torch.accel import library as tlib
from repro_torch.accel import synth as tsynth
from repro_torch.accel import units as tunits
from repro_torch.core import pruning as tpruning

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the apps held against the reference: all five
APPS_HELD = ["sobel", "gaussian", "fir15", "dct8", "kmeans"]


@pytest.fixture(scope="module")
def pruned():
    return jpruning.prune_library()[0], tpruning.prune_library()[0]


def _domains():
    """(kind, (ea, eb)) for every app's LUT domain."""
    out = set()
    for app in japps.APPS.values():
        for n in app.unit_nodes:
            if n.kind in jlib.LUT_DOMAINS:
                out.add((n.kind, jlib.lut_domain(app.name, n.kind)))
    return sorted(out)


@pytest.mark.parametrize("kind,domain", _domains())
def test_pruned_truth_tables_match(pruned, kind, domain):
    """Bit-exact on every app's LUT domain, the k-means tables included:
    the port evaluates exp2/log2 as XLA on the CPU does."""
    ea, eb = domain
    jent, tent = pruned[0][kind], pruned[1][kind]
    assert [e.inst.name for e in jent] == [e.inst.name for e in tent]
    for je, te in zip(jent, tent):
        want = np.asarray(je.inst.lut(ea, eb))
        got = te.inst.lut(ea, eb).numpy()
        np.testing.assert_array_equal(got, want, err_msg=te.inst.name)


def _addsub_operands(n: int):
    """Exhaustive pairs for n <= 10; for 12 and 16 bits every first
    operand against 16 second operands (edges, powers of two, random)."""
    if n <= 10:
        a = np.repeat(np.arange(1 << n), 1 << n)
        b = np.tile(np.arange(1 << n), 1 << n)
    else:
        rng = np.random.default_rng(n)
        bs = np.unique(np.concatenate([
            [0, 1, (1 << n) - 1, 1 << (n - 1), (1 << (n - 1)) - 1],
            rng.integers(0, 1 << n, 11)]))
        a = np.repeat(np.arange(1 << n), len(bs))
        b = np.tile(bs, 1 << n)
    return a.astype(np.int32), b.astype(np.int32)


@pytest.mark.parametrize("kind", ["add8", "sub10", "add12", "add16"])
def test_addsub_batched_bit_exact(kind):
    """Every library entry of the kind: the port's batched form against
    the JAX package's batched form and the port's scalar family."""
    k = tunits.KINDS[kind]
    a, b = _addsub_operands(k.width_a)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    insts = tlib.instances(kind)
    entries = tuple(tlib.LibEntry(i, *([0.0] * 7)) for i in insts)
    fam, kk, seg = tlib.addsub_dispatch(entries)
    for e, inst in enumerate(insts):
        got = tunits.addsub_batched(
            k.op, k.width_a, torch.tensor(fam[e]), torch.tensor(kk[e]),
            torch.tensor(seg[e]), ta, tb).numpy()
        want = np.asarray(junits.addsub_batched(
            k.op, k.width_a, jnp.int32(fam[e]), jnp.int32(kk[e]),
            jnp.int32(seg[e]), jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_array_equal(got, want, err_msg=inst.name)
        np.testing.assert_array_equal(got, inst.fn()(ta, tb).numpy(),
                                      err_msg=inst.name)


def test_library_metrics_and_pruning(pruned):
    """PPA identical; float32 error metrics at rtol 1e-6 (another
    reduction order over up to 2^20 values); pruned entry names identical
    for all 7 kinds."""
    for kind in tlib.TABLE_III:
        for je, te in zip(jlib.build_library(kind), tlib.build_library(kind)):
            assert je.inst.name == te.inst.name
            for f in ("area", "power", "latency"):
                assert getattr(te, f) == getattr(je, f)
            for f in ("mae", "mre", "mse", "wce"):
                assert getattr(te, f) == pytest.approx(getattr(je, f),
                                                       rel=1e-6), \
                    (te.inst.name, f)
    for kind in tlib.TABLE_III:
        assert [e.inst.name for e in pruned[0][kind]] == \
            [e.inst.name for e in pruned[1][kind]], kind


def _carried_entries(jentries):
    """The port's entries carrying the JAX package's metric values, so an
    oracle comparison sees identical inputs on both sides."""
    out = {}
    for kind, ents in jentries.items():
        tinsts = {i.name: i for i in tlib.instances(kind)}
        out[kind] = tuple(
            tlib.LibEntry(tinsts[e.inst.name], *(getattr(e, f) for f in (
                "mae", "mre", "mse", "wce", "area", "power", "latency")))
            for e in ents)
    return out


def _configs(app, entries, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, len(entries[u.kind]), n)
                     for u in app.unit_nodes], axis=1)


@pytest.mark.parametrize("name", ["sobel", "gaussian", "kmeans", "dct8",
                                  "fir15"])
def test_synthesize_and_timing_batch_match(pruned, name):
    """Crit bits identical, floats allclose at rtol 1e-12 (the same
    float64 NumPy arithmetic); the port's scalar oracle agrees with its
    batched one."""
    japp = japps.APPS[name]
    jent = {n.kind: pruned[0][n.kind] for n in japp.unit_nodes}
    tent = _carried_entries(jent)
    C = _configs(japp, jent, 24, seed=11)
    tapp = tapps.APPS[name]
    for fn in ("synthesize_batch", "timing_batch"):
        want = getattr(jbo, fn)(japp, jent, C)
        got = getattr(tbo, fn)(tapp, tent, C)
        assert got["node_ids"] == want["node_ids"]
        np.testing.assert_array_equal(got["crit"], want["crit"])
        for k, v in want.items():
            if k not in ("crit", "node_ids"):
                np.testing.assert_allclose(got[k], v, rtol=1e-12,
                                           err_msg=f"{fn}:{k}")
    rep = tbo.synthesize_batch(tapp, tent, C[:4])
    for i, row in enumerate(C[:4]):
        choice = {n.id: tent[n.kind][c] for n, c in zip(tapp.unit_nodes, row)}
        one = tsynth.synthesize(tapp, choice)
        assert one["critical_nodes"] == {
            nid for nid, on in zip(rep["node_ids"], rep["crit"][i]) if on}
        for k in ("area", "power", "latency"):
            assert one[k] == pytest.approx(rep[k][i], rel=1e-12)


@pytest.mark.parametrize("name", APPS_HELD)
def test_functional_model_matches(pruned, name):
    """On the 16x16 probe image: outputs before SSIM bit-identical to the
    JAX package's functional model, and the probe's 1 - SSIM allclose at
    1e-6 to the JAX package's `accuracy_ssim_batch` (float32 window
    moments summed in another order)."""
    japp, tapp = japps.APPS[name], tapps.APPS[name]
    jent = {n.kind: pruned[0][n.kind] for n in japp.unit_nodes}
    tent = {n.kind: pruned[1][n.kind] for n in tapp.unit_nodes}
    C = _configs(japp, jent, 6, seed=7)
    jinp, jexact = japps.probe_inputs(name, 16)
    tinp, _ = tapps.probe_inputs(name, 16, device="cpu")
    np.testing.assert_array_equal(tinp.numpy(), np.asarray(jinp))
    got_out = tapps.batch_outputs(tapp, tent, C[:3], tinp).numpy()
    for i, row in enumerate(C[:3]):
        choice = {n.id: jent[n.kind][c] for n, c in zip(japp.unit_nodes, row)}
        want = np.asarray(japp.run(japps.make_impls(japp, choice), jinp))
        np.testing.assert_array_equal(got_out[i], want, err_msg=f"{i}")
    want = 1.0 - japps.accuracy_ssim_batch(japp, jent, C, jinp, jexact,
                                           chunk=8)
    got = tbo.probe_batch(tapp, tent, C, chunk=4, device="cpu")
    np.testing.assert_allclose(got["probe_err16"], want, rtol=1e-6,
                               atol=1e-6)


def test_lut_domain_guard_raises_on_the_same_inputs(pruned):
    """Shrinking gaussian's mul8x4 domain below the pixel range raises in
    both packages; the untouched domain raises in neither."""
    key = ("gaussian", "mul8x4")
    japp, tapp = japps.APPS["gaussian"], tapps.APPS["gaussian"]
    jent = {n.kind: pruned[0][n.kind] for n in japp.unit_nodes}
    tent = {n.kind: pruned[1][n.kind] for n in tapp.unit_nodes}
    C = _configs(japp, jent, 4, seed=3)
    g = np.array(japps.probe_inputs("gaussian", 16)[0])
    old = (jlib.APP_LUT_DOMAINS[key], tlib.APP_LUT_DOMAINS[key])
    jlib.APP_LUT_DOMAINS[key] = tlib.APP_LUT_DOMAINS[key] = (4, 4)
    japps._batch_label_fn.cache_clear()
    tapps._batch_model.cache_clear()
    try:
        with pytest.raises(japps.LutDomainError):
            japps.accuracy_ssim_batch(japp, jent, C, jnp.asarray(g))
        with pytest.raises(tapps.LutDomainError, match="m0#0"):
            tapps.accuracy_ssim_batch(tapp, tent, C, torch.from_numpy(g))
    finally:
        jlib.APP_LUT_DOMAINS[key], tlib.APP_LUT_DOMAINS[key] = old
        japps._batch_label_fn.cache_clear()
        tapps._batch_model.cache_clear()
    tapps.accuracy_ssim_batch(tapp, tent, C, torch.from_numpy(g))


def test_stacked_lut_layout(pruned):
    ent = tuple(pruned[1]["mul8x4"][:3])
    tab = tlib.stacked_lut(ent, 8, 4)
    assert tab.shape == (3 << 12,) and tab.dtype == torch.int32
    np.testing.assert_array_equal(
        tab.numpy(), np.asarray(jlib.stacked_lut(
            tuple(pruned[0]["mul8x4"][:3]), 8, 4)))


_LIBRARY_UNDER_THREADS = """
import json, sys, torch
torch.set_num_threads(int(sys.argv[1]))
from repro_torch.accel import library as tlib
from repro_torch.core import pruning as tpruning
metrics = {e.inst.name: [e.mae, e.mre, e.mse, e.wce]
           for kind in tlib.TABLE_III for e in tlib.build_library(kind)}
pruned = {k: [e.inst.name for e in v]
          for k, v in tpruning.prune_library()[0].items()}
print(json.dumps({"threads": torch.get_num_threads(), "metrics": metrics,
                  "pruned": pruned}))
"""


def test_library_metrics_do_not_follow_the_thread_count(pruned):
    """The library built under 1 and under 4 intra-op threads, each in a
    fresh interpreter: every error metric identical, and the pruned sets
    of all 7 kinds equal to the reference's at both."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    runs = []
    for n in (1, 4):
        r = subprocess.run([sys.executable, "-c", _LIBRARY_UNDER_THREADS,
                            str(n)], env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    assert [r["threads"] for r in runs] == [1, 4]
    assert runs[0]["metrics"] == runs[1]["metrics"]
    want = {k: [e.inst.name for e in v] for k, v in pruned[0].items()}
    for r in runs:
        assert r["pruned"] == want, r["threads"]
