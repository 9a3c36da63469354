"""GPipe stages (`repro_torch.distributed.pipeline`) on the CPU.

Reduced Granite-3-2B blocks, 2 stages of 1 layer, 4 micro-batches of
2 x 8 tokens, over a stage mesh of one CPU device named twice: the
pipelined output equals the port's blocks applied in sequence, bit for
bit, and matches the reference's `pipelined` (a `shard_map` over 4
forced host devices, run once in a subprocess for the module) on the
same seeded inputs and carried-over weights, in float32 within
tests/test_torch_lm.py's F32_TOL and in bf16 within its BF16_TOL, the
bars that file holds Granite's blocks to.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import REDUCED_ARCHS as J_ARCHS
from repro.distributed import pipeline as jpp
from repro.models import transformer as jtr
from repro_torch.configs import REDUCED_ARCHS as T_ARCHS
from repro_torch.distributed import meshes
from repro_torch.distributed import pipeline as tpp
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import params_from_numpy, tree_map
from test_torch_lm import BF16_TOL, F32_TOL

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = torch.device("cpu")
ARCH = "granite-3-2b"
N_STAGES, N_MICRO, B, S = 2, 4, 2, 8
DTYPES = ("float32", "bfloat16")

# the reference's pipelined blocks on 4 forced host devices: the weights
# of ParamTable.init(PRNGKey(0)), the inputs of default_rng(0), both as
# this module makes them
_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.distributed import pipeline as pp
    from repro.configs import REDUCED_ARCHS
    from repro.models import transformer

    out_dir = sys.argv[1]
    assert jax.device_count() == 4
    for dtype in %(dtypes)r:
        cfg = dataclasses.replace(REDUCED_ARCHS[%(arch)r], dtype=dtype)
        params = transformer.build_param_table(cfg).init(
            jax.random.PRNGKey(0))
        blocks = transformer.cast_params(cfg, params)["blocks"]
        rng = np.random.default_rng(0)
        xs = jnp.asarray(rng.standard_normal(
            (%(n_micro)d, %(B)d, %(S)d, cfg.d_model)) * 0.3, dtype)
        pos = jnp.broadcast_to(jnp.arange(%(S)d, dtype=jnp.int32),
                               (%(B)d, %(S)d))

        def stage_fn(lp, x):
            return transformer.block_fwd(cfg, lp, x, pos)[0]

        mesh = jax.make_mesh((%(n_stages)d,), ("stage",))
        with mesh:
            out = jax.jit(pp.pipelined(stage_fn, %(n_stages)d,
                                       %(n_micro)d, mesh))(blocks, xs)
        np.save(f"{out_dir}/{dtype}.npy", np.asarray(out, np.float32))
    print("ok")
""") % dict(dtypes=DTYPES, arch=ARCH, n_micro=N_MICRO, B=B, S=S,
            n_stages=N_STAGES)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{dtype: the reference's pipelined output as float32}."""
    out = tmp_path_factory.mktemp("pipelined")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src")
    r = subprocess.run([sys.executable, "-c", _SCRIPT, str(out)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return {d: np.load(out / f"{d}.npy") for d in DTYPES}


def _port(dtype):
    """(config, stacked block params in the compute type, xs, positions)
    of the port, from the reference's weights and this module's seed."""
    jcfg = dataclasses.replace(J_ARCHS[ARCH], dtype=dtype)
    tcfg = dataclasses.replace(T_ARCHS[ARCH], dtype=dtype)
    jp = jtr.build_param_table(jcfg).init(jax.random.PRNGKey(0))
    tp = ttr.cast_params(tcfg, params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu"))
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal(
        (N_MICRO, B, S, tcfg.d_model)) * 0.3).to(getattr(torch, dtype))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    return tcfg, tp["blocks"], xs, pos


def _sequential(cfg, blocks, xs, pos):
    out = []
    for m in range(xs.shape[0]):
        x = xs[m]
        for layer in range(cfg.n_layers):
            x = ttr.block_fwd(cfg, ttr.layer_params(blocks, layer), x,
                              pos)[0]
        out.append(x)
    return torch.stack(out)


def test_bubble_fraction_matches_the_reference():
    for m in range(1, 17):
        for p in range(1, 9):
            assert tpp.bubble_fraction(m, p) == jpp.bubble_fraction(m, p)
    assert tpp.bubble_fraction(8, 4) == pytest.approx(3 / 11)
    assert tpp.bubble_fraction(1, 1) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_pipelined_blocks_equal_the_sequential_blocks(dtype):
    cfg, blocks, xs, pos = _port(dtype)
    assert cfg.n_layers == N_STAGES
    mesh = tpp.make_stage_mesh(N_STAGES, [CPU] * N_STAGES)
    assert mesh.shape == {"stage": N_STAGES}

    def stage_fn(lp, x):
        return ttr.block_fwd(cfg, lp, x, pos)[0]

    with torch.no_grad():
        got = tpp.pipelined(stage_fn, N_STAGES, N_MICRO, mesh)(blocks, xs)
        want = _sequential(cfg, blocks, xs, pos)
    assert got.shape == xs.shape and got.dtype == xs.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pipelined_blocks_match_the_reference(reference, dtype):
    cfg, blocks, xs, pos = _port(dtype)
    mesh = tpp.make_stage_mesh(N_STAGES, [CPU] * N_STAGES)

    def stage_fn(lp, x):
        return ttr.block_fwd(cfg, lp, x, pos)[0]

    with torch.no_grad():
        got = tpp.pipelined(stage_fn, N_STAGES, N_MICRO, mesh)(blocks, xs)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), reference[dtype], **tol)


def test_four_stages_of_grouped_layers_and_the_schedule():
    """A deeper stack grouped into stages of several layers (the layer
    axis reshaped to (stages, layers a stage)), 3 micro-batches through 4
    stages: equal to the sequential stack, each stage run once for each
    micro-batch."""
    cfg = dataclasses.replace(T_ARCHS[ARCH], n_layers=8)
    tp = ttr.build_param_table(cfg).init(torch.Generator().manual_seed(2),
                                         device="cpu")
    blocks = tp["blocks"]
    xs = torch.randn(3, B, S, cfg.d_model,
                     generator=torch.Generator().manual_seed(3))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    grouped = tree_map(lambda a: a.reshape(4, 2, *a.shape[1:]), blocks)
    calls = []

    def stage_fn(lp, x):
        calls.append(len(calls))
        for i in range(2):
            x = ttr.block_fwd(cfg, ttr.layer_params(lp, i), x, pos)[0]
        return x

    with torch.no_grad():
        got = tpp.pipelined(stage_fn, 4, 3, tpp.make_stage_mesh(
            4, [CPU] * 4))(grouped, xs)
        want = _sequential(cfg, blocks, xs, pos)
    assert torch.equal(got, want)
    assert len(calls) == 4 * 3


def test_stage_mesh_needs_its_devices():
    with pytest.raises(ValueError, match="needs 2 devices"):
        tpp.make_stage_mesh(2)
    mesh = meshes.data_parallel_mesh(devices=[CPU] * 2)
    with pytest.raises(ValueError, match="stage"):
        tpp.pipelined(lambda p, x: x, 2, 4, mesh)
