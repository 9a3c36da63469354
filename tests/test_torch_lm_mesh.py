"""The LM over a (data, model) mesh, part 1: the logical axes, the plans'
placements, placed tensors and their collectives, `ef_allreduce` over a
mesh axis, and every family on a mesh (`repro_torch.models.layers`,
`distributed.meshes`, `launch.steps.plan`, `distributed.compression`,
`distributed.spmd`) against the JAX package on the CPU.

The reference's plans and its `ef_allreduce` inside ``shard_map`` run in
one subprocess for the file, with 8 host devices (jax fixes the device
count when it starts), as `tests/test_sharding.py` runs its plans; this
process compares them with the port's on ``[cpu] * 8`` meshes.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_FULL
from repro.configs import REDUCED_ARCHS as J_ARCHS
from repro.models import transformer as jtr
from repro_torch.configs import ARCHS as T_FULL
from repro_torch.configs import REDUCED_ARCHS as T_ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import meshes as M
from repro_torch.distributed import spmd
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import PROD_MODEL_AXIS, head_axis, tree_leaves

CPU = torch.device("cpu")
PRESETS = ["baseline", "tp", "kv8", "serve8", "cp"]
KINDS = ["train", "prefill", "decode"]
# (name, full config?): reduced and full Granite-3-2B, one config of
# each other family
CONFIGS = [("granite-3-2b", False), ("granite-3-2b", True),
           ("mixtral-8x7b", False), ("hymba-1.5b", False),
           ("rwkv6-3b", False), ("whisper-large-v3", False),
           ("qwen2-vl-7b", True)]
SHAPES = {"train": ShapeConfig("t", 64, 16, "train", grad_accum=2),
          "prefill": ShapeConfig("p", 64, 8, "prefill"),
          "decode": ShapeConfig("d", 64, 8, "decode")}

_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.configs import ARCHS, REDUCED_ARCHS
    from repro.configs.base import ShapeConfig
    from repro.distributed import compression as C
    from repro.distributed import meshes as M
    from repro.launch import steps as S
    from repro.models import transformer

    def spec(s):
        return [list(e) if isinstance(e, tuple) else e for e in s.spec]

    def flat(tree, prefix, out):
        if isinstance(tree, NamedSharding):
            out[prefix] = spec(tree)
        elif isinstance(tree, dict):
            for k in sorted(tree):
                flat(tree[k], f"{prefix}/{k}", out)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                flat(v, f"{prefix}/{i}", out)
        return out

    cases, shapes = json.loads(sys.argv[1])
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    out = {}
    for name, full, preset, kind in cases:
        cfg = (ARCHS if full else REDUCED_ARCHS)[name]
        B, L, acc = shapes[kind]
        shape = ShapeConfig(kind, L, B, kind, grad_accum=acc)
        rules = M.PRESETS[preset]
        _fn, _specs, ins, outs, donate = S.plan(cfg, shape, mesh, rules)
        rec = {"in": flat(ins, "", {}), "out": flat(outs, "", {}),
               "donate": list(donate)}
        if kind == "train" and rules["compute"]:
            table = transformer.build_param_table(cfg)
            rec["compute"] = flat(M.param_shardings(
                mesh, table.logical_axes(), table.shapes(),
                rules["compute"], head_dim=cfg.resolved_head_dim), "", {})
        out["|".join(map(str, (name, full, preset, kind)))] = rec

    # ef_allreduce over "data" inside shard_map: device (d, m) holds
    # block d*4+m of each leaf
    rng = np.random.default_rng(7)
    g = {"a": rng.standard_normal((8 * 3, 5)).astype(np.float32),
         "b": rng.standard_normal((8 * 7,)).astype(np.float32) * 1e-3}
    r = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
         for k, v in g.items()}
    spec_in = P(("data", "model"))
    fn = shard_map(lambda gg, rr: C.ef_allreduce(gg, rr, "data"), mesh=mesh,
                   in_specs=(spec_in, spec_in), out_specs=(spec_in, spec_in),
                   check_rep=False)
    avg, res = jax.jit(fn)(jax.tree.map(jnp.asarray, g),
                           jax.tree.map(jnp.asarray, r))
    out["ef"] = {"g": {k: v.tolist() for k, v in g.items()},
                 "r": {k: v.tolist() for k, v in r.items()},
                 "avg": {k: np.asarray(v).tolist() for k, v in avg.items()},
                 "res": {k: np.asarray(v).tolist() for k, v in res.items()}}
    print(json.dumps(out))
""")


def _cases():
    return [(n, f, p, k) for n, f in CONFIGS for p in PRESETS for k in KINDS]


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src"))
    shapes = {k: (s.global_batch, s.seq_len, s.grad_accum)
              for k, s in SHAPES.items()}
    r = subprocess.run([sys.executable, "-c", _SCRIPT,
                        json.dumps([_cases(), shapes])],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, [CPU] * int(np.prod(shape)))


def _spec(p: M.Placement):
    return [list(e) if isinstance(e, tuple) else e for e in p.spec]


def _flat(tree, prefix, out):
    if isinstance(tree, M.Placement):
        out[prefix] = _spec(tree)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flat(tree[k], f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}/{i}", out)
    return out


# --------------------------------------------------------------------------
# logical axes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True])
def test_logical_axes_match_the_reference_for_every_config(full):
    """`ParamTable.logical_axes()` equals the reference's, in the same
    tree, for every config under `configs/`, full and reduced; the leaves'
    shapes too."""
    jr, tr = (J_FULL, T_FULL) if full else (J_ARCHS, T_ARCHS)
    assert set(jr) == set(tr)
    for name in jr:
        jt = jtr.build_param_table(jr[name])
        tt = ttr.build_param_table(tr[name])
        assert tt.logical_axes() == jt.logical_axes(), name
        shapes = tt.shapes()
        for path, (shape, _k, _s) in tt.defs.items():
            node = shapes
            for part in path.split("/"):
                node = node[part]
            assert tuple(node.shape) == shape and node.device.type == "meta"


def test_head_axis_and_table_arguments():
    assert PROD_MODEL_AXIS == 16
    assert head_axis(32) == "heads" and head_axis(4) == "heads_flat"
    t = ttr.ParamTable()
    with pytest.raises(AssertionError):
        t.add("w", (2, 3), ("embed",))
    t.add("w", (2, 3))
    assert t.logical_axes() == {"w": (None, None)}


# --------------------------------------------------------------------------
# the plans' placements
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,full", CONFIGS)
def test_plan_placements_match_the_reference(reference, name, full):
    """Every input and output placement of `plan`, train, prefill and
    decode, for the four executed presets and cp, equals the reference's
    `PartitionSpec` on a (2, 4) mesh; with compute rules, the compute
    placements (`param_shardings(..., compute, head_dim=)`) too."""
    mesh = _mesh((2, 4))
    cfg = (T_FULL if full else T_ARCHS)[name]
    for preset in PRESETS:
        for kind in KINDS:
            want = reference["|".join(map(str, (name, full, preset, kind)))]
            rules = tsteps.resolve_rules(preset)
            _fn, specs, ins, outs, donate = tsteps.plan(
                cfg, SHAPES[kind], mesh, rules)
            assert _flat(ins, "", {}) == want["in"], (preset, kind)
            assert _flat(outs, "", {}) == want["out"], (preset, kind)
            assert list(donate) == want["donate"]
            if "compute" in want:
                table = ttr.build_param_table(cfg)
                got = M.param_shardings(
                    mesh, table.logical_axes(), table.shapes(),
                    rules["compute"], head_dim=cfg.resolved_head_dim)
                assert _flat(got, "", {}) == want["compute"], preset


def test_full_granite_splits_its_attention_under_tp(reference):
    """Granite-3-2B at full width: ``wq`` over (data, model) in storage
    and over model alone in the tp compute placement; ``wk`` (KV = 8,
    "kv_flat") over model in storage and whole under TP; the vocabulary
    (49,155) whole."""
    rec = reference["granite-3-2b|True|tp|train"]
    assert rec["in"]["/0/blocks/attn/wq"] == [None, "data", "model"]
    assert rec["compute"]["/blocks/attn/wq"] == [None, None, "model"]
    assert rec["compute"]["/blocks/attn/wk"] == [None, None, None]
    assert rec["in"]["/0/embed/tokens"] == [None, "data"]
    assert rec["in"]["/0/head/w"] == ["data", None]
    red = reference["granite-3-2b|False|baseline|train"]
    assert red["in"]["/0/blocks/attn/wk"] == [None, "data", None]


# --------------------------------------------------------------------------
# placed tensors and collectives
# --------------------------------------------------------------------------

def test_place_gather_and_bytes():
    """A placed tensor's pieces are its spec's blocks on every position
    (replicated dims whole, a device named k times holding k pieces);
    gather rebuilds it; byte counts per position and device."""
    mesh = _mesh((2, 4))
    x = torch.arange(8 * 12 * 3, dtype=torch.float32).reshape(8, 12, 3)
    for spec in (M.P(), M.P("data"), M.P(None, "model"),
                 M.P("data", "model"), M.P(("data", "model"))):
        s = M.place(x, M.Placement(mesh, spec))
        assert torch.equal(s.gather(), x)
        assert len({p.data_ptr() for p in s.pieces}) == 8
        for piece, blk in zip(s.pieces, s.blocks()):
            assert torch.equal(piece, x[tuple(slice(a, b) for a, b in blk)])
    s = M.place(x, M.Placement(mesh, M.P("data", "model")))
    assert M.nbytes_per_position({"x": s}) == [12 * 3 * 4] * 8
    assert M.nbytes_per_device({"x": s}) == {"cpu": x.numel() * 4}
    r = M.place(x, M.replicated(mesh))
    assert M.nbytes_per_device(r) == {"cpu": 8 * x.numel() * 4}
    y = M.map_placed(lambda t: t * 2, s)
    assert torch.equal(y.gather(), x * 2) and y.spec == s.spec
    with pytest.raises(ValueError, match="does not split"):
        M.place(torch.zeros(3, 5), M.Placement(mesh, M.P("data")))


def test_collectives_and_their_transposes():
    """all_gather, reduce_scatter and all_reduce: float32 sums in mesh
    order, the same on every device of a group, and differentiable: the
    gradient of a gather is the reduce-scatter of its users' gradients,
    and of an all-reduce the all-reduce."""
    mesh = _mesh((2, 4))
    x = torch.randn(4, 8, dtype=torch.float64)
    s = M.place(x, M.Placement(mesh, M.P("data", "model")))
    g = M.all_gather(s, "model", 1)
    assert g.spec == M.P("data", None) and torch.equal(g.gather(), x)
    leaves = [p.clone().requires_grad_(True) for p in s.pieces]
    src = M.ShardedTensor(s.placement, s.shape, leaves)
    w = M.all_gather(src, "model", 1)
    sum((p * (i + 1)).sum() for i, p in enumerate(w.pieces)).backward()
    # position (d, m) reads its own block; its group (same d) of 4 users
    # weigh by 1..4 (d = 0) and 5..8 (d = 1)
    for i, leaf in enumerate(leaves):
        want = 10.0 if i < 4 else 26.0
        assert torch.all(leaf.grad == want), (i, leaf.grad)
    parts = [torch.full((3, 8), float(i), requires_grad=True)
             for i in range(8)]
    ps = M.ShardedTensor.from_pieces(M.Placement(mesh, M.P("data")), parts,
                                     ("model",))
    r = M.all_reduce(ps, "model")
    assert [float(p[0, 0].detach()) for p in r.pieces] == \
        [6.0] * 4 + [22.0] * 4
    assert r.partial == () and r.dtype == torch.float32
    rs = M.reduce_scatter(ps, "model", 1)
    assert rs.spec == M.P("data", "model")
    assert torch.equal(rs.gather(), r.pieces[0].new_tensor(
        [[6.0] * 8] * 3 + [[22.0] * 8] * 3))
    sum((p * (i + 1)).sum() for i, p in enumerate(rs.pieces)).backward()
    # the transpose of a reduce-scatter all-gathers: row block m of every
    # group member's gradient is its shard's weight
    assert torch.equal(parts[0].grad[0],
                       torch.tensor([1., 1, 2, 2, 3, 3, 4, 4]))
    assert torch.equal(parts[5].grad[0],
                       torch.tensor([5., 5, 6, 6, 7, 7, 8, 8]))
    with pytest.raises(ValueError, match="not partial"):
        M.all_reduce(ps, ("data", "model"))
    a = M.place(torch.ones(2, 2), M.replicated(mesh))
    for i, p in enumerate(a.pieces):
        p.mul_(i)
    M.sync_replicas(a)
    assert all(torch.all(p == 28.0) for p in a.pieces)


def test_sum_order_is_the_mesh_order():
    """A group's float32 sum is taken in mesh order, on every device the
    same, whatever the magnitudes (1e8 + 1 - 1e8 != 1 - 1e8 + 1e8)."""
    mesh = _mesh((1, 3))
    vals = [1e8, 1.0, -1e8]
    ps = M.ShardedTensor.from_pieces(
        M.Placement(mesh, M.P()), [torch.tensor([v]) for v in vals],
        ("model",))
    got = M.all_reduce(ps, "model")
    want = (torch.tensor([1e8]) + 1.0) - 1e8
    assert all(torch.equal(p, want) for p in got.pieces)


def test_global_norm_counts_each_block_once():
    """`meshes.global_norm` of placed leaves equals `adamw.global_norm` of
    the gathered leaves: a replicated leaf's 8 copies, and a leaf split
    over one axis and replicated over the other, count each element
    once."""
    from repro_torch.optim import adamw
    mesh = _mesh((2, 4))
    g = torch.Generator().manual_seed(3)
    xs = [torch.randn(8, 12, generator=g) for _ in range(4)]
    specs = (M.P(), M.P("data"), M.P(None, "model"), M.P("data", "model"))
    placed = [M.place(x, M.Placement(mesh, s)) for x, s in zip(xs, specs)]
    got = M.global_norm(placed)
    want = adamw.global_norm(xs)
    assert float(abs(got - want)) <= 1e-6 * float(want)


# --------------------------------------------------------------------------
# ef_allreduce over a mesh axis
# --------------------------------------------------------------------------

def test_ef_allreduce_over_data_matches_shard_map(reference):
    """The reference's `ef_allreduce` inside `shard_map` over "data" on 8
    host devices (device (d, m) holding block 4d + m), against the port's
    over the same axis of a (2, 4) mesh of placed leaves: the same int8
    codes, int32 sums, mean scales and residuals."""
    ef = reference["ef"]
    mesh = _mesh((2, 4))
    g, r = {}, {}
    for k in ef["g"]:
        ga = torch.tensor(ef["g"][k], dtype=torch.float32)
        ra = torch.tensor(ef["r"][k], dtype=torch.float32)
        n = ga.shape[0] // 8
        pl = M.Placement(mesh, M.P("model"))
        g[k] = M.ShardedTensor.from_pieces(
            pl, list(ga.split(n)), ("data",))
        r[k] = M.ShardedTensor.from_pieces(pl, list(ra.split(n)),
                                           ("data",))
    avg, res = tcomp.ef_allreduce(g, r, "data")
    for k in ef["avg"]:
        want = np.asarray(ef["avg"][k], np.float32)
        got = torch.cat(avg[k].pieces).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
        # the jitted reference fuses ``target - q * scale`` (one rounding
        # fewer): the residuals agree to float32 rounding of the target
        target = torch.cat(g[k].pieces) + torch.cat(r[k].pieces)
        np.testing.assert_allclose(
            torch.cat(res[k].pieces).numpy(),
            np.asarray(ef["res"][k], np.float32), rtol=0,
            atol=2 * float(np.spacing(np.float32(target.abs().max()))))
        assert avg[k].partial == ()
        n = len(avg[k].pieces) // 2
        for i in range(n):      # the same on both data positions
            assert torch.equal(avg[k].pieces[i], avg[k].pieces[i + n])
    with pytest.raises(TypeError, match="placed"):
        tcomp.ef_allreduce({"a": torch.ones(3)}, None, axis_name="data")


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    """torch's CPU ops on one thread for the test (restored after it): a
    mesh's many small ops otherwise spin for the cores against the other
    test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["rwkv6-3b", "whisper-large-v3"])
def test_non_dense_family_on_a_mesh_raises(name, one_thread):
    """RWKV-6 and Whisper, the last families the mesh layer took on
    (`tests/test_torch_lm_mesh_whisper_rwkv.py` holds their results),
    run every kind of `plan`'s step on (2, 2) under every preset to
    finite outputs of the planned placements: the training step, a
    prefill and a decode step from its cache (int8 where the preset and
    the family have it), 8 rows of 16 positions; and
    `launch.train.train(..., mesh=)`. Nothing raises and nothing falls
    back to one device."""
    from repro_torch.models import decoding
    cfg = T_ARCHS[name]
    mesh = _mesh((2, 2))
    params, _ = ttrain.build_state(cfg, "cpu")
    rng = np.random.default_rng(0)
    shapes = {"train": ShapeConfig("t", 16, 8, "train", grad_accum=2),
              "prefill": ShapeConfig("p", 16, 8, "prefill"),
              "decode": ShapeConfig("d", 16, 8, "decode")}

    def batch_of(specs):
        return {k: (rng.integers(0, cfg.vocab_size, s).astype(np.int32)
                    if dt == torch.int32 else
                    (rng.standard_normal(s) * .02).astype(np.float32))
                for k, (s, dt) in specs.items()}
    for preset in PRESETS:
        rules = tsteps.resolve_rules(preset)
        fn, specs, ins, outs, _d = tsteps.plan(cfg, shapes["train"], mesh,
                                               rules)
        P = M.place_tree(params, ins[0])
        P, O, m = fn(P, tsteps.init_opt(P), batch_of(specs[2]))
        assert np.isfinite(float(m["loss"])) and int(O.step.pieces[0]) == 1
        pfn, pspecs, pins, pouts, _d = tsteps.plan(cfg, shapes["prefill"],
                                                   mesh, rules)
        lg, cache = pfn(M.place_tree(params, pins[0]), batch_of(pspecs[1]))
        assert lg.spec == pouts[0].spec and torch.isfinite(lg.gather()).all()
        # the prefill's cache of S slots, a ring the step at S wraps
        dfn, _s, dins, douts, _d = tsteps.plan(cfg, shapes["decode"], mesh,
                                               rules)
        if rules.get("kv_int8") and decoding.has_int8_cache(cfg):
            cache = spmd.quantize_cache(cfg, cache)
        tok = torch.zeros((8, 1), dtype=torch.int32)
        lg, cache = dfn(M.place_tree(params, dins[0]), cache, tok,
                        shapes["prefill"].seq_len)
        assert lg.spec == douts[0].spec and torch.isfinite(lg.gather()).all()
        for leaf, pl in zip(tree_leaves(cache), tree_leaves(dins[1])):
            assert leaf.spec == pl.spec
    out = ttrain.train(cfg, ShapeConfig("t", 8, 4, "train"), 1, None,
                       mesh=mesh, log_every=0)
    assert out["mesh"] == (("data", 2), ("model", 2))
    assert np.isfinite(out["losses"]).all()


def test_cp_preset_on_a_mesh_raises():
    """No config raises any more (the name is the refusal test's this
    replaced): every config under `configs/`, full and reduced, is
    supported (`spmd.supports`), passes `spmd.check_supported` on (2, 2)
    and gets `plan`'s training step there under every preset, cp
    included."""
    mesh = _mesh((2, 2))
    shape = ShapeConfig("t", 16, 8, "train", grad_accum=2)
    for archs in (T_FULL, T_ARCHS):
        for cfg in archs.values():
            assert spmd.supports(cfg)
            spmd.check_supported(cfg, mesh)
            for preset in PRESETS:
                tsteps.plan(cfg, shape, mesh, tsteps.resolve_rules(preset))


def test_default_mesh_keeps_other_families_on_one_device(monkeypatch,
                                                        one_thread):
    """With ``mesh=None`` and two local devices, `train` spreads every
    family over both (Whisper and RWKV-6 too, which trains there); a
    device named by its index gets a mesh of one position."""
    from repro_torch import device as device_lib
    monkeypatch.setattr(device_lib, "local_devices", lambda kind=None:
                        [CPU, CPU])
    for cfg in T_ARCHS.values():
        assert ttrain.default_mesh(cfg, "cpu").size == 2, cfg.name
        assert ttrain.default_mesh(cfg, "cpu:0").size == 1, cfg.name
    cfg = T_ARCHS["rwkv6-3b"]
    out = ttrain.train(cfg, ShapeConfig("t", 8, 2, "train"), 2, None,
                       log_every=0, device="cpu")
    assert out["mesh"] == (("data", 1), ("model", 2))
    assert out["final_step"] == 2 and all(map(np.isfinite, out["losses"]))
