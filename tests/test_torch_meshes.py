"""The port's device meshes (`repro_torch.distributed.meshes`,
`repro_torch.launch.mesh`) against the JAX package's on the CPU.

The reference's spec functions read only ``mesh.shape``, so they are
handed `jax.sharding.AbstractMesh`es of the same shapes (no devices
needed); the port's functions get port meshes over one CPU device named
as often as the shape needs. `make_mesh_for`'s factorization is read off
the reference by standing in for `jax.make_mesh` in this process.
"""
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.distributed import meshes as jm
from repro.launch import mesh as jlaunch
from repro_torch.distributed import meshes as tm
from repro_torch.launch import mesh as tlaunch

CPU = torch.device("cpu")
SHAPES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((8, 1), ("data", "model")),
          ((2, 4), ("data", "model")),
          ((1, 1), ("data", "model"))]
# (shape, logical axes) of every kind of LM leaf: flat head dims that do
# and do not split into whole heads, embed/vocab/ff, stacked layers
LEAVES = [((2048, 2048), ("embed", "heads_flat")),
          ((2048, 512), ("embed", "kv_flat")),
          ((2048, 192), ("embed", "kv_flat")),
          ((1600, 1600), ("embed", "heads_flat")),
          ((40, 2048, 8192), ("layers", "embed", "ff")),
          ((40, 8192, 2048), ("layers", "ff", "embed")),
          ((49155, 2048), ("vocab", "embed")),
          ((2048, 49152), ("embed", "vocab")),
          ((64, 2048, 1408), ("experts", "embed", "ff")),
          ((8, 32, 64), ("state", "heads", None)),
          ((2048,), (None,)),
          ((24, 24), ("heads", "heads"))]
CACHES = [(40, 8, 1024, 8, 64), (8, 1024, 8, 64), (8, 1024), (32, 8, 2560),
          (32, 8, 40, 64, 64), (1, 3, 33, 5, 7), (3, 5)]


def _pair(shape, axes):
    n = int(np.prod(shape))
    return AbstractMesh(shape, axes), tlaunch.make_mesh(shape, axes,
                                                        [CPU] * n)


def _spec(p):
    return tuple(p)


@pytest.mark.parametrize("shape,axes", SHAPES)
def test_mesh_shape_and_axis_sizes(shape, axes):
    jmesh, tmesh = _pair(shape, axes)
    assert tmesh.shape == jmesh.shape
    assert list(tmesh.shape) == list(axes)
    assert tmesh.size == int(np.prod(shape))
    assert tm.batch_axes(tmesh) == jm.batch_axes(jmesh)
    for name in (None, *axes, tuple(axes[:2]), jm.batch_axes(jmesh)):
        assert tm.axis_size(tmesh, name) == jm.axis_size(jmesh, name)
    for dim in (0, 1, 2, 7, 8, 16, 24, 32, 48, 256, 512, 1600, 49155):
        for name in (None, *axes, jm.batch_axes(jmesh)):
            assert tm.maybe(tmesh, dim, name) == jm.maybe(jmesh, dim, name)


@pytest.mark.parametrize("shape,axes", SHAPES)
@pytest.mark.parametrize("preset", sorted(jm.PRESETS))
def test_spec_for_every_preset_matches_the_reference(shape, axes, preset):
    """Every preset's storage and compute rules, with and without the
    head-alignment fallback (head_dim 64 and 100: 192 = 3 heads of 64
    splits over no axis of 2 or more, 1600 = 16 heads of 100 over 16)."""
    assert tm.PRESETS.keys() == jm.PRESETS.keys()
    jmesh, tmesh = _pair(shape, axes)
    for kind in ("storage", "compute"):
        jr, tr = jm.PRESETS[preset][kind], tm.PRESETS[preset][kind]
        assert tr == jr
        if jr is None:
            continue
        for leaf_shape, logical in LEAVES:
            for head_dim in (None, 64, 100):
                got = tm.spec_for(tmesh, leaf_shape, logical, tr,
                                  head_dim=head_dim)
                want = jm.spec_for(jmesh, leaf_shape, logical, jr,
                                   head_dim=head_dim)
                assert _spec(got) == _spec(want), (leaf_shape, logical,
                                                   head_dim)


def test_rule_tables_and_head_axes_match():
    assert tm.BASE_RULES == jm.BASE_RULES
    assert tm.TP_RULES == jm.TP_RULES
    assert tm.CP_RULES == jm.CP_RULES
    assert tm.HEAD_FLAT_AXES == jm.HEAD_FLAT_AXES
    for name in jm.PRESETS:
        assert {k: v for k, v in tm.PRESETS[name].items()
                if k not in ("storage", "compute")} == \
            {k: v for k, v in jm.PRESETS[name].items()
             if k not in ("storage", "compute")}


def test_head_alignment_fallback():
    """A flat head dim whose slice would cut a head is replicated."""
    mesh = tlaunch.make_mesh((1, 16), ("data", "model"), [CPU] * 16)
    jmesh = AbstractMesh((1, 16), ("data", "model"))
    cases = [((1600, 1600), 64, ("data", None)),    # 100 a slice: cut
             ((1600, 1600), None, ("data", "model")),
             ((2048, 2048), 64, ("data", "model")),  # 2 whole heads
             ((2048, 512), 64, ("data", None))]      # 32: half a head
    for shape, head_dim, want in cases:
        got = tm.spec_for(mesh, shape, ("embed", "heads_flat"),
                          head_dim=head_dim)
        assert got == tm.P(*want)
        assert _spec(got) == _spec(jm.spec_for(
            jmesh, shape, ("embed", "heads_flat"), head_dim=head_dim))


@pytest.mark.parametrize("shape,axes", SHAPES)
def test_data_specs_match_the_reference(shape, axes):
    jmesh, tmesh = _pair(shape, axes)
    for batch in (1, 2, 8, 16, 24, 32, 512, 1024):
        for ndim, seq_axis, seq_len in ((2, None, 0), (3, 1, 1024),
                                        (3, 1, 1000), (4, 2, 4096)):
            got = tm.data_sharding(tmesh, batch, ndim, seq_axis, seq_len)
            want = jm.data_sharding(jmesh, batch, ndim, seq_axis, seq_len)
            assert isinstance(got, tm.Placement) and got.mesh is tmesh
            assert _spec(got.spec) == _spec(want.spec)
    assert tm.replicated(tmesh).spec == tm.P()


@pytest.mark.parametrize("shape,axes", SHAPES)
def test_cache_specs_match_the_reference_on_every_mesh(shape, axes,
                                                       monkeypatch):
    """`cache_shardings` on every mesh shape: the reference builds a
    `NamedSharding`, which needs a concrete mesh; stand in for it with the
    spec, as `make_mesh_for`'s test stands in for `jax.make_mesh`."""
    jmesh, tmesh = _pair(shape, axes)
    monkeypatch.setattr(jm, "NamedSharding", lambda mesh, spec: spec)
    import jax
    want = jm.cache_shardings(jmesh, [jax.ShapeDtypeStruct(s, np.float32)
                                      for s in CACHES])
    got = tm.cache_shardings(tmesh, [torch.zeros(1).expand(*s)
                                     for s in CACHES])
    assert [_spec(g.spec) for g in got] == [_spec(w) for w in want]


def test_param_shardings_match_the_reference(monkeypatch):
    monkeypatch.setattr(jm, "NamedSharding", lambda mesh, spec: spec)
    import jax
    jmesh, tmesh = _pair((2, 4), ("data", "model"))
    logical = {"blocks": {"wq": ("layers", "embed", "heads_flat"),
                          "w": [("embed", "ff"), ("ff", "embed")]},
               "embed": ("vocab", "embed")}
    shapes = {"blocks": {"wq": (4, 64, 256), "w": [(64, 96), (96, 64)]},
              "embed": (1000, 64)}

    def as_j(t):
        if isinstance(t, dict):
            return {k: as_j(v) for k, v in t.items()}
        if isinstance(t, list):
            return [as_j(v) for v in t]
        return jax.ShapeDtypeStruct(t, np.float32)

    def as_t(t):
        if isinstance(t, dict):
            return {k: as_t(v) for k, v in t.items()}
        if isinstance(t, list):
            return [as_t(v) for v in t]
        return torch.zeros(1).expand(*t)

    for rules in (tm.BASE_RULES, tm.TP_RULES):
        want = jm.param_shardings(jmesh, logical, as_j(shapes), rules,
                                  head_dim=32)
        got = tm.param_shardings(tmesh, logical, as_t(shapes), rules,
                                 head_dim=32)
        assert _spec(got["blocks"]["wq"].spec) == \
            _spec(want["blocks"]["wq"])
        assert [_spec(p.spec) for p in got["blocks"]["w"]] == \
            [_spec(p) for p in want["blocks"]["w"]]
        assert _spec(got["embed"].spec) == _spec(want["embed"])


# --------------------------------------------------------------------------
# launch.mesh
# --------------------------------------------------------------------------

RATIOS = (1.0, 0.5, 2.0, 4.0, 0.125, 3.0)


@pytest.mark.parametrize("ratio", RATIOS)
def test_make_mesh_for_shapes_match_the_reference(ratio, monkeypatch):
    """n = 1..64 at several data/model ratios: the reference's
    factorization, read by standing in for `jax.make_mesh`."""
    monkeypatch.setattr(jlaunch.jax, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    for n in range(1, 65):
        want_shape, want_axes = jlaunch.make_mesh_for(
            n, data_model_ratio=ratio)
        got = tlaunch.make_mesh_for(n, data_model_ratio=ratio,
                                    devices=[CPU] * n)
        assert tuple(got.shape.values()) == want_shape, n
        assert tuple(got.shape) == want_axes


def test_production_and_smoke_meshes(monkeypatch):
    monkeypatch.setattr(jlaunch.jax, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    for multi in (False, True):
        shape, axes = jlaunch.make_production_mesh(multi_pod=multi)
        mesh = tlaunch.make_production_mesh(multi_pod=multi,
                                            devices=[CPU] * 512)
        assert tuple(mesh.shape.values()) == shape
        assert mesh.axis_names == axes
        # one CPU device: fewer than the mesh needs
        with pytest.raises(ValueError, match=str(int(np.prod(shape)))):
            tlaunch.make_production_mesh(multi_pod=multi)
    shape, axes = jlaunch.make_smoke_mesh()
    smoke = tlaunch.make_smoke_mesh()
    assert tuple(smoke.shape.values()) == shape and smoke.axis_names == axes
    assert smoke.device_list() == [CPU]


# --------------------------------------------------------------------------
# the leading-axis split
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,n_dev,cap,want", [
    (48, 8, None, 8), (48, 5, None, 4), (12, 8, None, 6), (7, 8, None, 7),
    (7, 3, None, 1), (9, 2, None, 1), (16, 8, 3, 2), (16, 8, 1, 1),
    (1, 8, None, 1), (512, 4, None, 4), (300, 8, None, 6)])
def test_shard_leading_axis_prefix_rule(n, n_dev, cap, want):
    """The largest prefix of the devices whose size divides n, capped at
    max_devices; the tree unchanged when that is one device; otherwise
    slice i on device i, concatenating back to the input."""
    rng = np.random.default_rng(n)
    tree = {"x": torch.from_numpy(rng.standard_normal((n, 3, 2))),
            "i": [torch.arange(n), rng.integers(0, 9, (n, 4))]}
    devs = [CPU] * n_dev
    got = tm.shard_leading_axis(tree, n, axis_name="island",
                                max_devices=cap, devices=devs)
    assert tm.split_count(n, min(n_dev, cap or n_dev)) == want
    if want == 1:
        assert got is tree
        return
    assert isinstance(got, tm.Sharded)
    assert got.mesh.shape == {"island": want}
    assert len(got.shards) == want
    assert all(s["x"].shape[0] == n // want for s in got.shards)
    back = got.gather()
    assert torch.equal(back["x"], tree["x"])
    assert torch.equal(back["i"][0], tree["i"][0])
    assert np.array_equal(back["i"][1].numpy(), tree["i"][1])
    # the slices of a tensor on its own device are views
    assert got.shards[1]["x"].data_ptr() == \
        tree["x"][n // want:].data_ptr()


def test_shard_leading_axis_defaults_to_the_local_devices():
    """With no device list the local devices are used: one CPU here, so
    nothing is split (the reference's one-device identity case)."""
    x = torch.arange(8)
    assert tm.shard_leading_axis(x, 8) is x
    assert tm.data_parallel_mesh() is not None
    assert tm.data_parallel_mesh(min_devices=2) is None
    m = tm.data_parallel_mesh(devices=[CPU] * 4)
    assert m.shape == {"data": 4}
    assert jm.data_parallel_mesh(min_devices=2) is None
