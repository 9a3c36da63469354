"""Each family's plain reference against the program, `repro_torch`, at
the architecture's REDUCED sizes on the CPU, both in float32: the
prefill's last logits and cache, at each shape of the cells' mixes cut
to size."""
from __future__ import annotations

import pytest
import torch

from pbench import compare, generator, harness, program, small, weights

program.load(harness.ROOT)

BENCH = harness.Bench()
CASES = sorted({(w["config"], w["traffic"])
                for w in BENCH.doc["workloads"]})
SHAPES = 2                   # small.mix's
# float32 on both sides, the products summed in another order
TOL = 2e-5


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,traffic,shape", [
    c + (k,) for c in CASES for k in range(SHAPES)])
def test_prefill_logits_and_cache_match_the_program(name, traffic, shape,
                                                    one_thread):
    conf = small.config(BENCH.config(name), dtype="float32")
    mix = small.mix(BENCH.traffic(traffic))
    assert len(mix["shapes"]) == SHAPES
    ref = BENCH.reference(conf["family"])
    w = weights.make(ref.declare(conf), 2 ** 35 + 1, "cpu", torch.float32)
    prog = program.Prefill(conf)
    batch = generator.make_batch(conf, mix, 7, -1 - shape, "cpu")
    with torch.no_grad():
        logits, cache = prog(weights.nest(
            {p: t.clone() for p, t in w.items()}), batch)
    want_logits, want = ref.prefill(conf, w, batch)
    scale = want_logits.abs().max()
    assert (logits - want_logits).abs().max() <= TOL * scale
    got = prog.cache_entries(cache)
    S = batch["tokens"].shape[1]
    for n, layers in want.items():
        for a, b in zip(got[n], layers):
            slots = compare.ring_positions(a.shape[1], S, "cpu")
            assert (slots >= 0).all()
            b = b[:, slots]
            # the program keeps k and v in bf16: one rounding of each
            bar = (2.0 ** -8 if a.dtype == torch.bfloat16 else 0) \
                * b.abs() + TOL * b.abs().max()
            assert ((a.float() - b).abs() <= bar).all(), n
    assert all(torch.equal(p, compare.ring_positions(p.shape[1], S, "cpu")
                           .expand_as(p)) for p in got["pos"])

