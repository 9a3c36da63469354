"""The port's dataset containers against the JAX package on the CPU:
`AccelDataset.split`, `flat_features` and its pickle hooks, and
`merge` / `MergedDataset` (`view`, `denorm_rows`, `n_pad`) with the
reference's edge cases, on datasets both packages label through the
scalar loop path from the same seed."""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

from repro.core import dataset as jds
from repro.core import pruning as jpruning
from repro_torch.accel import apps as tapps
from repro_torch.core import dataset as tds
from repro_torch.core import graph as tgraph
from repro_torch.core import pruning as tpruning

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

APPS = ["sobel", "gaussian", "fir15", "dct8", "kmeans"]
BUILD = dict(n_samples=8, seed=1, n_images=1, img_size=16,
             label_backend="loop")
ROW_ARRAYS = ("adj", "x", "mask", "unit_mask", "y", "y_raw", "crit")


@pytest.fixture(scope="module")
def both():
    """name -> (reference dataset, port dataset), and the port's entries."""
    jpr, tpr = jpruning.prune_library()[0], tpruning.prune_library()[0]
    out, entries = {}, {}
    for name in APPS:
        kinds = {n.kind for n in tapps.APPS[name].unit_nodes}
        entries[name] = {k: tpr[k] for k in kinds}
        out[name] = (jds.build(name, lib_entries={k: jpr[k] for k in kinds},
                               **BUILD),
                     tds.build(name, lib_entries=entries[name],
                               device="cpu", **BUILD))
    return out, entries


def _close(got, want, what):
    """Integer-valued arrays equal; float arrays at the slice test's rtol
    1e-5 (x also atol 1e-5)."""
    if got.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)


def test_split_and_flat_features_match(both):
    """`split` cuts at the same row on both sides and carries every row
    array; `flat_features` allclose at rtol 1e-5 / atol 1e-5."""
    pairs, _ = both
    for name, (jd, td) in pairs.items():
        for frac in (0.75, 0.9):
            for jpart, tpart in zip(jd.split(frac), td.split(frac)):
                assert tpart.configs == jpart.configs
                assert tpart.app_name == name
                for k in ROW_ARRAYS:
                    _close(getattr(tpart, k), getattr(jpart, k), f"{name} {k}")
                np.testing.assert_array_equal(tpart.y_mean, td.y_mean)
        np.testing.assert_allclose(td.flat_features(), jd.flat_features(),
                                   rtol=1e-5, atol=1e-5)
        us = td.schema.sl("unit_stats")
        assert td.flat_features().shape == (
            len(td.y), td.x.shape[1] * (us.stop - us.start))


def test_pickle_round_trip_is_compact_and_drops_the_featurizer(both):
    """The constant adjacency and masks travel as one row each, the
    featurizer cache is dropped, and every array comes back equal."""
    pairs, entries = both
    td = pairs["gaussian"][1]
    feat = tds.featurizer_for(td, tapps.APPS["gaussian"],
                              entries["gaussian"], "cpu")
    assert td.__dict__["_featurizers"]
    blob = pickle.dumps(td)
    back = pickle.loads(blob)
    assert "_featurizers" not in back.__dict__
    assert len(blob) < len(pickle.dumps(td.adj)) + len(pickle.dumps(td.x))
    for k in ROW_ARRAYS + ("y_mean", "y_std", "x_mean", "x_std"):
        np.testing.assert_array_equal(getattr(back, k), getattr(td, k))
    assert back.configs == td.configs
    assert back.graph.node_ids == td.graph.node_ids
    np.testing.assert_array_equal(back.graph.adj, td.graph.adj)
    assert tds.featurizer_for(back, tapps.APPS["gaussian"],
                              entries["gaussian"], "cpu") is not feat


@pytest.mark.parametrize("seed", [0, 3])
def test_merge_matches_reference(both, seed):
    """`merge` of the port's five datasets against `repro.core.dataset.
    merge` of the reference's: app order, app_ids, configs and row order
    equal (the same `default_rng` permutation); every array at rtol 1e-5
    / atol 1e-5, integer-valued ones equal."""
    pairs, _ = both
    jm = jds.merge({a: j for a, (j, _) in pairs.items()}, shuffle_seed=seed)
    tm = tds.merge({a: t for a, (_, t) in pairs.items()}, shuffle_seed=seed)
    assert tm.app_names == jm.app_names == tuple(tgraph.APP_VOCAB)
    np.testing.assert_array_equal(tm.app_ids, jm.app_ids)
    assert tm.configs == jm.configs
    for k in ROW_ARRAYS:
        _close(getattr(tm, k), getattr(jm, k), k)
    assert tm.x.shape[-1] == tgraph.MERGED_FEATURE_DIM
    for i, a in enumerate(tm.app_names):
        rows = tm.app_ids == i
        block = tm.x[rows][..., tgraph.FEATURE_DIM:]
        np.testing.assert_array_equal(
            block[..., tgraph.APP_VOCAB.index(a)], tm.mask[rows])
        assert block.sum() == tm.mask[rows].sum()


def test_view_denorm_rows_and_n_pad(both):
    """`view` keeps one app's rows in merged order, `denorm_rows` gives
    back each row's own y_raw (float32 round trip, rtol 1e-5), both as
    the reference's; `split` of the merged set as the reference's."""
    pairs, _ = both
    jm = jds.merge({a: j for a, (j, _) in pairs.items()})
    tm = tds.merge({a: t for a, (_, t) in pairs.items()})
    assert tm.n_pad == jm.n_pad == 32
    for a in tm.app_names:
        tv, jv = tm.view(a), jm.view(a)
        assert tv.configs == jv.configs
        assert sorted(tv.configs) == sorted(pairs[a][1].configs)
        np.testing.assert_array_equal(tv.app_ids, jv.app_ids)
        _close(tv.x, jv.x, a)
    np.testing.assert_allclose(tm.denorm_rows(tm.y), tm.y_raw, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tm.denorm_rows(tm.y), jm.denorm_rows(jm.y),
                               rtol=1e-5)
    ids = np.zeros(len(tm.y), np.int64)
    np.testing.assert_allclose(tm.denorm_rows(tm.y, ids),
                               jm.denorm_rows(jm.y, ids), rtol=1e-5)
    for tpart, jpart in zip(tm.split(0.8), jm.split(0.8)):
        assert tpart.configs == jpart.configs
        np.testing.assert_array_equal(tpart.app_ids, jpart.app_ids)
        assert tpart.per_app is tm.per_app


def test_merge_single_app_keeps_layout(both):
    one = tds.merge({"sobel": both[0]["sobel"][1]}, n_pad=32)
    assert one.app_names == ("sobel",)
    assert one.x.shape[1:] == (32, tgraph.MERGED_FEATURE_DIM)
    assert one.n_pad == 32 and (one.app_ids == 0).all()


def test_merge_pads_square_feature_tensor_correctly():
    """A dataset built at n_pad == FEATURE_DIM has a square feature
    tensor; padding widens only the node axis."""
    ds = tds.build("sobel", n_samples=6, n_images=1, img_size=16,
                   n_pad=tgraph.FEATURE_DIM, device="cpu")
    assert ds.x.shape[1] == ds.x.shape[2] == tgraph.FEATURE_DIM
    merged = tds.merge({"sobel": ds}, n_pad=32)
    assert merged.x.shape[1:] == (32, tgraph.MERGED_FEATURE_DIM)
    assert merged.adj.shape[1:] == (32, 32)
    with pytest.raises(ValueError, match="cannot pad"):
        tds._pad_nodes(ds.x, 8)


def test_merge_rejects_empty_unknown_and_mixed_schemas(both):
    with pytest.raises(ValueError):
        tds.merge({})
    with pytest.raises(ValueError):
        tgraph.app_block("not-an-app", np.ones(4, np.float32))
    with pytest.raises(ValueError):
        tds.merge({"not-an-app": both[0]["sobel"][1]})
    stale = dataclasses.replace(both[0]["gaussian"][1], schema_version=1)
    with pytest.raises(ValueError, match="schema"):
        tds.merge({"sobel": both[0]["sobel"][1], "gaussian": stale})
