"""The port's kernels: plain PyTorch versions against the JAX package's
Pallas kernels (interpret mode), the per-device dispatch, and — on a CUDA
card only — each CUDA kernel against its plain version.

The JAX side is imported inside the parity tests so that the card-only
test collects on a host without JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gnn_mp as gnn_mp_kernel
from repro_torch.kernels import lut_eval as lut_eval_kernel
from repro_torch.kernels import ops, ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GNN_SHAPES = [(2, 8, 16, 8), (4, 32, 21, 48), (3, 16, 24, 24), (8, 32, 8, 304)]
LUT_CASES = [("mul8", 8, 8, 5, 4096), ("mul8x4", 8, 4, 3, 4096),
             ("add8", 8, 8, 7, 4096),
             # ragged: not a multiple of the reference's block
             ("mul8x4", 8, 4, 2, 4096 + 700), ("add8", 8, 8, 4, 1023)]


def _gnn_inputs(B, N, F, Fo, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((B, N, N)).astype(np.float32),
            rng.standard_normal((B, N, F)).astype(np.float32),
            (rng.standard_normal((F, Fo)) * 0.1).astype(np.float32),
            (rng.standard_normal((F, Fo)) * 0.1).astype(np.float32),
            (rng.standard_normal(Fo) * 0.1).astype(np.float32))


@pytest.mark.parametrize("B,N,F,Fo", GNN_SHAPES)
def test_gnn_mp_ref_matches_pallas(B, N, F, Fo):
    """fp32 with another summation order: rtol/atol 1e-5, the bar the
    reference's own kernel test sets."""
    import jax.numpy as jnp
    from repro.kernels import gnn_mp as pallas_gnn_mp
    arrs = _gnn_inputs(B, N, F, Fo, seed=B * 1000 + N)
    want = np.asarray(pallas_gnn_mp.gnn_mp(*map(jnp.asarray, arrs),
                                           interpret=True))
    got = ref.gnn_mp_ref(*map(torch.from_numpy, arrs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,wa,wb,idx,M", LUT_CASES)
def test_lut_eval_ref_matches_pallas(kind, wa, wb, idx, M):
    """Integer gather: bit-exact."""
    import jax.numpy as jnp
    from repro.accel import library as jlib
    from repro.kernels import lut_eval as pallas_lut
    inst = jlib.instances(kind)[idx]
    lut = np.array(pallas_lut.build_lut(inst.fn(), wa, wb))
    rng = np.random.default_rng(M + idx)
    a = rng.integers(0, 1 << wa, M).astype(np.int32)
    b = rng.integers(0, 1 << wb, M).astype(np.int32)
    want = np.asarray(pallas_lut.lut_eval(
        jnp.asarray(lut), jnp.asarray(a), jnp.asarray(b), wb=wb,
        block=1024, interpret=True))
    got = ref.lut_eval_ref(torch.from_numpy(lut), torch.from_numpy(a),
                           torch.from_numpy(b), wb).numpy()
    assert got.shape == (M,)
    np.testing.assert_array_equal(got, want)


def test_gnn_mp_ref_shared_adjacency_equals_batched():
    adj, h, ws, wn, b = map(torch.from_numpy, _gnn_inputs(5, 12, 7, 9, 3))
    shared = ref.gnn_mp_ref(adj[0], h, ws, wn, b)
    batched = ref.gnn_mp_ref(adj[0].expand(5, 12, 12), h, ws, wn, b)
    torch.testing.assert_close(shared, batched, rtol=0, atol=0)


def test_ops_on_cpu_run_the_plain_versions_and_launch_nothing():
    adj, h, ws, wn, b = map(torch.from_numpy, _gnn_inputs(3, 8, 6, 5, 1))
    lut = torch.arange(64, dtype=torch.int32) * 7
    a = torch.tensor([0, 3, 7, 5], dtype=torch.int32)
    bb = torch.tensor([1, 0, 7, 2], dtype=torch.int32)
    n_mp, n_lut = gnn_mp_kernel.LAUNCHES.value, lut_eval_kernel.LAUNCHES.value
    torch.testing.assert_close(ops.gnn_mp(adj, h, ws, wn, b),
                               ref.gnn_mp_ref(adj, h, ws, wn, b),
                               rtol=0, atol=0)
    assert torch.equal(ops.lut_eval(lut, a, bb, 3), lut[(a << 3) | bb])
    assert (gnn_mp_kernel.LAUNCHES.value, lut_eval_kernel.LAUNCHES.value) \
        == (n_mp, n_lut)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch or raise: no silent plain-version fallback."""
    adj, h, ws, wn, b = map(torch.from_numpy, _gnn_inputs(2, 4, 3, 5, 2))
    with pytest.raises(ValueError, match="CUDA"):
        gnn_mp_kernel.gnn_mp(adj, h, ws, wn, b)
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        lut_eval_kernel.lut_eval(x, x, x, 0)


def test_lut_eval_ref_keeps_out_of_domain_indices_in_the_table():
    lut = torch.arange(16, dtype=torch.int32)
    a = torch.tensor([-1, 20, 3], dtype=torch.int32)
    zero = torch.zeros(3, dtype=torch.int32)
    assert ref.lut_eval_ref(lut, a, zero, 0).tolist() == [15, 15, 3]


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """On the card: each CUDA kernel against its plain version at the
    main path's shapes (fp32 with another summation order: rtol/atol
    1e-4; the gather bit-exact), ragged sizes included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    # the engine's shapes; N = 21 (not a divisor of the block's 64 rows),
    # one graph of 64 a block, F = 1 with Fo = 8, an odd Fo (weights
    # staged by 4-byte copies, scalar stores); H x 1e3, where the small
    # terms of 3xTF32 decide the result, held at the bar in units of the
    # scale (the fp32 plain version itself misses an absolute 1e-4 there)
    for B, N, F, Fo, scale in [(512, 32, 27, 300, 1), (512, 32, 300, 300, 1),
                               (37, 32, 300, 300, 1), (64, 21, 27, 300, 1),
                               (16, 64, 300, 300, 1), (40, 32, 1, 8, 1),
                               (48, 7, 13, 37, 1),
                               (512, 32, 300, 300, 1e3),
                               *((*shape, 1) for shape in GNN_SHAPES)]:
        adj, h, ws, wn, b = (torch.from_numpy(x).to(dev)
                             for x in _gnn_inputs(B, N, F, Fo, seed=B + F))
        h = h * scale
        # h also from a start 4 bytes past a 16-byte boundary: the kernel
        # then stages H by 4-byte copies
        shifted = torch.empty(h.numel() + 1, device=dev)[1:].view_as(h)
        for hh in (h, shifted.copy_(h)):
            for a in (adj, adj[0], adj[0].expand(B, N, N)):
                got = gnn_mp_kernel.gnn_mp(a, hh, ws, wn, b)
                want = ref.gnn_mp_ref(a, hh, ws, wn, b)
                torch.testing.assert_close(got / scale, want / scale,
                                           rtol=1e-4, atol=1e-4)
    rng = np.random.default_rng(0)
    for n_lut, wb, M in [(17 << 8, 0, 1 << 20), (17 << 12, 4, 4096 + 700),
                         (6 << 20, 0, 1023)]:
        lut = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n_lut,
                                            dtype=np.int64).astype(np.int32))
        a = torch.from_numpy(rng.integers(0, n_lut >> wb, M).astype(np.int32))
        b = torch.from_numpy(rng.integers(0, 1 << wb, M).astype(np.int32))
        got = lut_eval_kernel.lut_eval(lut.to(dev), a.to(dev), b.to(dev), wb)
        assert torch.equal(got.cpu(), ref.lut_eval_ref(lut, a, b, wb))
        if wb == 0:   # no b: both paths, a start off a 16-byte boundary
            for x in (a, a[1:]):
                got = lut_eval_kernel.lut_eval(lut.to(dev), x.to(dev))
                assert torch.equal(got.cpu(), ref.lut_eval_ref(lut, x))
    torch.cuda.synchronize()


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest, ties
    away from zero, at bit 13 of the fp32 bits."""
    bits = x.view(torch.int32)
    return ((bits + (1 << 12)) & -(1 << 13)).view(torch.float32)


def test_3xtf32_holds_the_fp32_bar_where_one_tf32_product_does_not():
    """Why the kernel's 3xTF32 needs no looser bar than fp32: on the
    engine's hidden-layer product, (4096 x 300) @ (300 x 300), split
    operands (hi = tf32(x), lo = tf32(x - hi); hi*hi plus the small terms
    lo*hi + hi*lo summed apart, TF32 products exact in fp32) stay within
    rtol/atol 1e-4 of float64, as fp32 does; one TF32 product does not."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((4096, 300)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((300, 300))
                          * 300 ** -0.5).astype(np.float32))
    exact = a.double() @ b.double()
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    three = ah @ bh + (al @ bh + ah @ bl)
    one = ah @ bh
    for got, holds in ((a @ b, True), (three, True), (one, False)):
        assert torch.allclose(got.double(), exact, rtol=1e-4,
                              atol=1e-4) == holds
    assert (three.double() - exact).abs().max() < 1e-5
    assert (one.double() - exact).abs().max() > 1e-3


# the five tables of the main paths: (kind, ea, eb, column of a
# constant coefficient or None) -- Gaussian's mul8x4 column and full
# (8, 4) table, DCT-8's (13, 4), k-means' mul8 (9, 9) and sqrt18 (20, 0);
# two library instances stacked, as `library.stacked_lut` stacks them
LUT_TABLES = [("mul8x4", 8, 4, 4), ("mul8x4", 8, 4, None),
              ("mul8x4", 13, 4, None), ("mul8", 9, 9, None),
              ("sqrt18", 20, 0, None)]


@pytest.mark.parametrize("kind,ea,eb,column", LUT_TABLES)
def test_lut_eval_ref_without_b_matches_pallas_with_zero_b(kind, ea, eb,
                                                           column):
    """``lut_eval_ref(lut, a, None, 0)`` against the reference kernel fed
    a zero b (wb = 0), as the port's callers passed it before: bit-exact
    over the whole table, a ragged M."""
    import jax.numpy as jnp
    from repro.accel import library as jlib
    from repro.kernels import lut_eval as pallas_lut
    lut = np.concatenate([np.asarray(inst.lut(ea, eb))
                          for inst in jlib.instances(kind)[:2]])
    if column is not None:
        lut = np.ascontiguousarray(lut.reshape(-1, 1 << eb)[:, column])
    rng = np.random.default_rng(lut.shape[0])
    M = 4096 + 77
    a = rng.integers(0, lut.shape[0], M).astype(np.int32)
    want = np.asarray(pallas_lut.lut_eval(
        jnp.asarray(lut), jnp.asarray(a), jnp.zeros(M, jnp.int32), wb=0,
        block=1024, interpret=True))
    got = ref.lut_eval_ref(torch.from_numpy(lut), torch.from_numpy(a),
                           None, 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(ops.lut_eval(torch.from_numpy(lut),
                                    torch.from_numpy(a)), got)


@pytest.mark.parametrize("table_bytes,path", [
    (17 * 256 * 4, "shared"),                    # Gaussian's column
    (lut_eval_kernel.STAGE_MAX_BYTES, "shared"),
    (lut_eval_kernel.STAGE_MAX_BYTES + 4, "global"),
    (17 << 14, "global"),                        # Gaussian's (8, 4), 272 KiB
    (6 << 22, "global")])                        # k-means' sqrt18, 24 MiB
def test_lut_eval_path_by_table_bytes(table_bytes, path):
    """Small tables are staged in shared memory, the rest read through
    the caches; a block's shared memory holds the largest staged one."""
    assert lut_eval_kernel.path(table_bytes) == path
    assert lut_eval_kernel.STAGE_MAX_BYTES <= 232448


def test_lut_eval_refuses_no_b_with_b_bits():
    """b=None stands for b = 0 and only means that with wb == 0."""
    x = torch.zeros(4, dtype=torch.int32)
    for fn in (lut_eval_kernel.lut_eval, ops.lut_eval, ref.lut_eval_ref):
        with pytest.raises(ValueError, match="wb"):
            fn(x, x, None, 3)
    with pytest.raises(ValueError, match="CUDA"):
        lut_eval_kernel.lut_eval(x, x)
