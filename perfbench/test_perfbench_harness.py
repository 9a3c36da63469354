"""The harness finds its files by name, counts by hand sums, and runs a
cell end to end on the CPU at small sizes (the card's runs are the
benchmark's own)."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from pbench import counting, generator, harness, program, small, weights

program.load(harness.ROOT)

BENCH = harness.Bench()
DOC = BENCH.doc


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_every_name_finds_its_file():
    for wl in DOC["workloads"]:
        conf = BENCH.config(wl["config"])
        mix = BENCH.traffic(wl["traffic"])
        driver = BENCH.driver(mix["driver"])
        assert callable(driver.Driver) and driver.FAULTS
        assert BENCH.limits(wl["name"])
        assert callable(BENCH.reference(conf["family"]).declare)
        layer = BENCH.per_layer(wl["name"])
        assert layer and BENCH.end_to_end(wl["name"])
        for m in layer + BENCH.end_to_end(wl["name"]):
            assert callable(BENCH.reader(m["name"]).read)
    for c in DOC["configs"]:
        assert c["file"] == f"{DOC['paths'][0]}/configs/{c['name']}.json"
        assert BENCH.config(c["name"])["name"] == c["name"]
    with pytest.raises(KeyError):
        BENCH.workload("no-such-cell")
    with pytest.raises(FileNotFoundError):
        BENCH.traffic("no-such-mix")
    with pytest.raises(FileNotFoundError):
        BENCH.driver("no-such-driver")


def test_metrics_go_to_the_cells_that_report_what_they_move():
    assert {m["name"] for m in BENCH.per_layer("qwen2-vl-7b.prefill")} == {
        "mfu.prefill", "device_idle.prefill", "k3_roofline.prefill"}
    assert {m["name"] for m in BENCH.end_to_end("qwen2-vl-7b.prefill")} == {
        "prefill_tokens_per_s", "prefill_ms_p95", "setup_s"}
    for wl in DOC["workloads"]:
        moved = {m["name"] for m in BENCH.end_to_end(wl["name"])}
        assert all(m["moves"] in moved for m in BENCH.per_layer(wl["name"]))


CONFIGS = sorted(p.stem for p in (BENCH.dir / "configs").glob("*.json"))


@pytest.mark.parametrize("name", CONFIGS)
def test_configuration_files_are_the_programs_published_shapes(name):
    """The file's every size is the registered architecture's but the
    keys in ``reduced``, whose published values ``published`` keeps; no
    width is cut; the reference declares the program's leaves."""
    from repro_torch.configs import get_arch
    conf = BENCH.config(name)
    arch = get_arch(conf["arch"])
    assert set(conf["reduced"]) == set(conf.get("published", {}))
    assert set(conf["reduced"]) <= {"n_layers"}
    for f in dataclasses.fields(arch):
        if f.name in conf and f.name != "name":
            want = (arch.resolved_head_dim if f.name == "head_dim"
                    else getattr(arch, f.name))
            got = conf.get("published", {}).get(f.name, conf[f.name])
            assert (tuple(got) if isinstance(got, list) else got) == want, \
                f.name
    declared = BENCH.reference(conf["family"]).declare(conf)
    meta = {p: torch.empty(s[0], device="meta") for p, s in declared.items()}
    program.check_weights(program.arch_config(conf), meta)
    if "parameters" in conf:
        n = sum(torch.Size(s[0]).numel() for s in declared.values())
        assert n == conf["parameters"]


def test_counts_against_hand_sums():
    q = BENCH.config("qwen2-vl-7b")
    layer = 2 * 3584 * 3584 + 2 * 3584 * 512 + 3 * 3584 * 18944
    pairs = 1024 * 1025 // 2
    assert counting.attention_pairs(1024, 1024) == pairs
    want = (2 * 8 * 1024 * 28 * layer + 2 * 8 * 3584 * 152064
            + 4 * 8 * 28 * 128 * pairs * 28)
    assert counting.prefill_flops(q, 8, 1024) == want
    assert abs(want - 1.087e14) < 0.001e14
    # Hymba-1.5B (arXiv:2411.13676) as the port runs it
    h = dict(family="hybrid", n_layers=32, d_model=1600, n_heads=25,
             n_kv_heads=5, head_dim=64, d_ff=5504, vocab_size=32001,
             ssm_state=16, swa_window=1024, global_attn_every=8)
    hl = (2 * 1600 * 1600 + 2 * 1600 * 320 + 3 * 1600 * 5504
          + 2 * 1600 * 1600 + 1600 * 32 + 1600 * 25 + 1600 * 1600)
    fwd = (2 * 8192 * 32 * hl + 2 * 8192 * 1600 * 32001
           + 4 * 8 * 25 * 64 * pairs * 32)
    assert counting.train_flops(h, 8, 1024) == 3 * fwd
    # the window cuts nothing at 1,024 positions; at 2,048 it does
    assert counting.attention_pairs(2048, 2048, True, 1024) == sum(
        min(p + 1, 1024) for p in range(2048))
    # chip_smoke.py's bounds: K3 at Qwen2-VL's and Hymba's prefill, K4
    f, b = counting.k3_cost(8, 28, 4, 1024, 1024, 128)
    assert counting.bound_s(b, f) == pytest.approx((60.9e-6, "operations"),
                                                  rel=1e-3)
    f, b = counting.k3_cost(8, 25, 5, 1024, 1024, 64)
    assert counting.bound_s(b, f)[0] == pytest.approx(27.2e-6, rel=2e-3)
    f, b = counting.k4_cost(1024, 204800, 200)
    assert counting.bound_s(b, f, counting.PEAK_FP32_FLOPS) == \
        pytest.approx((501.5e-6, "bytes"), rel=1e-3)
    assert counting.k3_bound_s(q, 8, 1024) == pytest.approx(28 * 60.9e-6,
                                                           rel=1e-3)


def test_products_count_as_the_flop_counter_reads_the_reference():
    """The count's products and head against `FlopCounterMode` over the
    reference's prefill, whose attention computes every pair (4 x D a
    pair and head) where the count takes the causal half."""
    from torch.utils.flop_counter import FlopCounterMode
    from pbench import generator
    conf = small.config(BENCH.config("qwen2-vl-7b"), dtype="float32")
    mix = small.mix(BENCH.traffic("prefill_8k_mixed"))
    ref = BENCH.reference("vlm")
    w = weights.make(ref.declare(conf), 1, "cpu", torch.float32)
    batch = generator.make_batch(conf, mix, 1, -2, "cpu")
    with FlopCounterMode(display=False) as fc:
        ref.prefill(conf, w, batch)
    B, S = batch["tokens"].shape
    full = 4 * B * conf["n_heads"] * conf["head_dim"] * S * S \
        * conf["n_layers"]
    causal = 4 * B * conf["n_heads"] * conf["head_dim"] \
        * counting.attention_pairs(S, S) * conf["n_layers"]
    assert fc.get_total_flops() - full == \
        counting.prefill_flops(conf, B, S) - causal


def test_weights_are_drawn_alike_from_the_seed():
    spec = ((3, 5), "normal", 0.5)
    a = weights.leaf(spec, "x/w", 2 ** 40 + 3, "cpu", torch.float32)
    assert torch.equal(a, weights.leaf(spec, "x/w", 2 ** 40 + 3, "cpu",
                                       torch.float32))
    assert not torch.equal(a, weights.leaf(spec, "x/v", 2 ** 40 + 3, "cpu",
                                           torch.float32))
    tree = weights.nest({"a/b": a, "c": a})
    assert tree["a"]["b"] is a and weights.flatten(tree) == {"a/b": a,
                                                             "c": a}


@pytest.mark.parametrize("workload", [w["name"] for w in DOC["workloads"]])
def test_a_cell_runs_end_to_end_on_the_cpu_at_small_sizes(workload,
                                                         one_thread):
    wl = BENCH.workload(workload)
    conf = small.config(BENCH.config(wl["config"]))
    mix = small.mix(BENCH.traffic(wl["traffic"]))
    out = harness.run_cell(BENCH, workload, 2 ** 33 + 5, 0.05, False, "cpu",
                           conf=conf, mix=mix)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = {m["name"] for m in BENCH.end_to_end(workload)}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["checks"]) == set(BENCH.limits(workload))
    json.dumps(out)


def test_every_seed_runs_every_shape_in_each_block_in_its_own_order():
    mix = BENCH.traffic("prefill_8k_mixed")
    n = len(mix["shapes"])
    assert len({generator.tokens(s) for s in mix["shapes"]}) == 1
    orders = set()
    for seed in (2 ** 40 + 1, 2 ** 40 + 2, 7):
        got = [mix["shapes"].index(generator.shape_of(mix, seed, i))
               for i in range(4 * n)]
        for b in range(4):
            assert sorted(got[b * n:(b + 1) * n]) == list(range(n))
        orders.add(tuple(got))
    assert len(orders) > 1
    assert [generator.shape_of(mix, 5, -1 - i) for i in range(n)] == \
        mix["shapes"]


def test_mrope_positions_follow_qwen2_vls_rule():
    """Two images of 2 x 3 and 2 x 2 cells, then text."""
    pos = generator.mrope_positions(2, 13, [(2, 3), (2, 2)], "cpu")
    want = [(0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, 0), (0, 1, 1), (0, 1, 2),
            (3, 3, 3), (3, 3, 4), (3, 4, 3), (3, 4, 4),
            (5, 5, 5), (6, 6, 6), (7, 7, 7)]
    assert pos.shape == (2, 13, 3)
    assert [tuple(r) for r in pos[1].tolist()] == want
    with pytest.raises(ValueError):
        generator.mrope_positions(1, 6, [(2, 3)], "cpu")


def test_end_to_end_readers_take_the_whole_window():
    from types import SimpleNamespace
    call_s = [0.1 * (i + 1) for i in range(20)]
    ctx = SimpleNamespace(stats={"calls": 20, "seconds": 2.5,
                                 "call_s": call_s, "tokens": 20 * 8192},
                          setup_s=12.5)
    read = {m["name"]: BENCH.reader(m["name"]).read(ctx)
            for m in BENCH.end_to_end("qwen2-vl-7b.prefill")}
    assert read == {"prefill_tokens_per_s": pytest.approx(20 * 8192 / 2.5),
                    "prefill_ms_p95": pytest.approx(1905.0),
                    "setup_s": 12.5}


def test_the_live_pool_holds_the_last_calls_caches(one_thread):
    wl = BENCH.workload("qwen2-vl-7b.prefill")
    conf = small.config(BENCH.config(wl["config"]))
    mix = small.mix(BENCH.traffic(wl["traffic"]), live_calls=3)
    drv = BENCH.driver(mix["driver"]).Driver(
        conf, mix, 2 ** 33 + 7, "cpu", BENCH.reference(conf["family"]))
    drv.setup()
    # the first call's cache and blocks of its size in the pool
    assert len(drv.live) == 3
    assert isinstance(drv.live[0], torch.Tensor)
    drv.window(0.0)
    assert drv.stats["calls"] == len(mix["shapes"])
    assert sorted(drv.kept) == list(range(len(mix["shapes"])))
    newest = drv.kept[max(drv.kept, key=lambda k: drv.kept[k][0])][2]
    assert drv.live[-1] is newest
    assert all(isinstance(c, dict) for c in drv.live)
    assert set(drv.phases) == {"program", "weights", "first_call",
                               "live_pool", "warmup"}
    drv.release()
    assert not drv.live


def test_the_cli_refuses_without_the_card_or_the_program(tmp_path,
                                                         monkeypatch):
    import runpy
    run = Path(__file__).with_name("run.py")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = runpy.run_path(str(run))
    assert mod["main"](["--workload", "qwen2-vl-7b.prefill", "--seed",
                        "1", "--seconds", "1"]) == 2
    monkeypatch.setitem(mod["main"].__globals__, "ROOT", tmp_path)
    assert mod["main"](["--workload", "qwen2-vl-7b.prefill", "--seed",
                        "1", "--seconds", "1"]) == 2
