"""Per-device dry-run counts over a mesh (`repro_torch.launch.dryrun`'s
mesh cells, `launch.op_profile.profile_mesh`, the count mode of
`distributed.meshes`' collectives, `distributed.spmd.classes`) on the
CPU, at reduced configs on meta tensors.

The count runs one position of each class. It is held against a count of
every position (each alone), against the whole step run on every
position outside the count, against the one-card count divided by the
mesh size plus the terms that the split replicates, against the JAX
package's compiled per-device HLO (`hlo_profile.analyze`, in one
subprocess with 8 host devices, as `tests/test_torch_lm_mesh.py` runs its
reference), and, for the collectives of a tp training step, against a
sum derived by hand. The `dryrun` and `roofline` CLIs' records, keys and
filters are held against the reference's.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import roofline as jroof
from repro_torch.configs import REDUCED_ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import meshes as M
from repro_torch.distributed import spmd
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, op_profile, roofline, steps
from repro_torch.models import moe


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The count's tensors are meta tensors and the reference's are a few
    KB: run torch's CPU ops on one thread (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape(kind, S=16, B=8, accum=1):
    return ShapeConfig(kind, S, B, kind, grad_accum=accum)


# (family's config, kind, preset, mesh): every family, kind and mesh shape,
# and each of baseline, tp, cp and serve8 at least once
CASES = [
    ("granite-3-2b", "train", "tp", "2x4"),
    ("granite-3-2b", "decode", "serve8", "2x2x2"),
    ("moonshot-v1-16b-a3b", "train", "baseline", "2x2x2"),
    ("moonshot-v1-16b-a3b", "decode", "tp", "2x4"),
    ("hymba-1.5b", "prefill", "cp", "2x4"),
    ("hymba-1.5b", "decode", "serve8", "2x4"),
    ("qwen2-vl-7b", "train", "cp", "2x2x2"),
    ("whisper-large-v3", "prefill", "cp", "2x2x2"),
    ("whisper-large-v3", "decode", "baseline", "2x4"),
    ("rwkv6-3b", "prefill", "baseline", "2x4"),
    ("rwkv6-3b", "decode", "tp", "2x2x2"),
]
KEYS = ("dot_flops", "hbm_bytes", "peak_bytes", "collective_operand_bytes",
        "collective_wire_bytes", "memory", "op_census", "n_ops")
_COUNTS = {}


def _counts(case):
    """(collapsed profiles, brute-force profiles, the mesh, the build)."""
    if case not in _COUNTS:
        name, kind, preset, mesh_name = case
        mesh = dryrun.mesh_of(mesh_name)
        build, classes = dryrun.build_mesh_step(
            REDUCED_ARCHS[name], _shape(kind), mesh,
            steps.resolve_rules(preset))
        _COUNTS[case] = (
            op_profile.profile_mesh(build, mesh, classes),
            op_profile.profile_mesh(build, mesh,
                                    [[i] for i in range(mesh.size)]),
            mesh, build)
    return _COUNTS[case]


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_collapsed_count_equals_every_position(case):
    """(a) Each position's numbers from its class's one counted position
    equal those of a count of that position alone, the collectives by
    kind included."""
    collapsed, brute, mesh, _ = _counts(case)
    covered = sorted(i for c in collapsed for i in c["positions"])
    assert covered == list(range(mesh.size))
    per = {i: c for c in collapsed for i in c["positions"]}
    for b in brute:
        i = b["positions"][0]
        for k in KEYS:
            assert b[k] == per[i][k], (i, k)
        assert b["collectives"] == per[i]["collectives"], i
    if case[1] == "decode" and case[0] != "rwkv6-3b":
        # the model shard holding slot step % W is a class of its own
        assert len(collapsed) == 2
    if case[2] == "cp" and case[1] != "decode":
        # each model rank reads its own number of keys
        assert len(collapsed) == mesh.shape["model"]


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_positions_sum_to_the_whole_step(case):
    """(b) The positions' dot FLOPs summed over the mesh equal the whole
    step's, run on every position outside the count (the collectives
    copying and summing) under torch's own `FlopCounterMode`."""
    _, brute, _, build = _counts(case)
    fn, args = build()
    flops = FlopCounterMode(display=False)
    walk = op_profile._Walk(args)
    ops.COUNTER = walk
    try:
        with flops, walk:
            fn(*args)
    finally:
        ops.COUNTER = None
    total = flops.get_total_flops() + walk.kernel_dot_flops
    assert sum(b["dot_flops"] for b in brute) == total > 0


# --------------------------------------------------------------------------
# (c) exact splits: the one-card count / n plus the replicated terms
# --------------------------------------------------------------------------

def _head_term(cfg, rows, dp, n):
    """The prefill's vocabulary-whole head: every model shard multiplies
    its rows' last position by the whole (d, V) head, where one card's
    B rows would split n ways."""
    return 2 * cfg.d_model * cfg.vocab_size * (rows // dp - rows / n)


def _kv_term(cfg, lay, tokens, m):
    """KV heads shared by shards: a shard projects the KV heads of its
    query heads (all of one KV head when H/m < G), where the KV heads
    would split m ways; k and v, 2·d·D a token each."""
    lo, hi = lay.kv_heads(0)
    return 2 * 2 * cfg.d_model * cfg.resolved_head_dim * \
        (hi - lo - cfg.n_kv_heads / m) * tokens * cfg.n_layers


def _router_term(cfg, tokens, m):
    """The router, whole on every model shard: 2·d·E a token, where it
    would split m ways."""
    return 2 * cfg.d_model * cfg.n_experts * tokens * (1 - 1 / m) * \
        cfg.n_layers


def _expert_term(cfg, C, m, n):
    """The experts' buffers: each position runs its E/m experts over the
    whole batch's C places (`moe.expert_partial`), three (C, d)·(d, f)
    products an expert, where they would split n ways."""
    return 3 * 2 * C * cfg.d_model * cfg.expert_d_ff * cfg.n_experts * \
        (1 / m - 1 / n) * cfg.n_layers


@pytest.mark.parametrize("name,kind", [("granite-3-2b", "prefill"),
                                       ("granite-3-2b", "train"),
                                       ("moonshot-v1-16b-a3b", "prefill")])
def test_per_device_flops_are_the_split_plus_replicated_terms(name, kind):
    """(c) Reduced Granite (H=4, KV=2: one query head and one shared KV
    head a model shard) and Moonlight (4 experts, one a shard) on (2, 4)
    under tp, where every other product splits exactly. Training's loss
    runs each shard's S/m positions with the whole vocabulary, so its
    head splits exactly; its products are 3x the forward's (no remat)."""
    cfg = REDUCED_ARCHS[name]
    S, B = 16, 8
    shape = _shape(kind, S, B)
    one = dryrun.run_cell(cfg, shape, verbose=False)
    rec = dryrun.run_cell(cfg, shape, mesh="2x4", rules_name="tp",
                          verbose=False)
    assert one["status"] == rec["status"] == "ok", rec.get("error")
    mesh = dryrun.mesh_of("2x4")
    dp, m, n = 2, 4, 8
    lay = spmd.Layout(cfg, mesh)
    tokens = B // dp * S
    kv = _kv_term(cfg, lay, tokens, m)
    if kind == "train":
        want = one["flops"] / n + 3 * kv
    else:
        want = one["flops"] / n + kv + _head_term(cfg, B, dp, n)
    if cfg.is_moe:
        want += _router_term(cfg, tokens, m) + _expert_term(
            cfg, moe.capacity(cfg, B * S), m, n)
    assert [c["flops"] for c in rec["classes"]] == [rec["flops"]]
    assert rec["flops"] == pytest.approx(want, rel=1e-12)


# --------------------------------------------------------------------------
# (d) the reference's compiled per-device HLO on 8 host devices
# --------------------------------------------------------------------------

_REF = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, sys
    import jax
    from repro.configs import REDUCED_ARCHS
    from repro.configs.base import ShapeConfig
    from repro.distributed import meshes as M
    from repro.launch import hlo_profile
    from repro.launch import steps as S

    cases, seq, batch = json.loads(sys.argv[1])
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    cfg = dataclasses.replace(REDUCED_ARCHS["granite-3-2b"], attn_chunk=seq)
    out = {}
    for kind, preset in cases:
        shape = ShapeConfig(kind, seq, batch, kind)
        fn, specs, ins, outs, donate = S.plan(cfg, shape, mesh,
                                              M.PRESETS[preset])
        with mesh:
            text = jax.jit(fn, in_shardings=ins, out_shardings=outs,
                           donate_argnums=tuple(donate)).lower(
                *specs).compile().as_text()
        out[kind + "|" + preset] = hlo_profile.analyze(text)["dot_flops"]
    print(json.dumps(out))
""")
REF_CASES = [("prefill", "baseline"), ("prefill", "tp"),
             ("decode", "baseline")]
REF_S, REF_B = 32, 4


@pytest.fixture(scope="module")
def reference_counts():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src"))
    r = subprocess.run([sys.executable, "-c", _REF,
                        json.dumps([REF_CASES, REF_S, REF_B])],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind,preset", REF_CASES, ids="-".join)
def test_per_device_flops_match_the_reference(reference_counts, kind,
                                              preset):
    """Reduced Granite at S=32, B=4 on (2, 4), attention unchunked on
    both sides (``attn_chunk`` = S, as `tests/test_torch_roofline.py`
    holds the one-card counts). GSPMD splits the reference's every product
    8 ways. The port differs by the one-card count's head terms (its
    head runs at the last position of each row, the reference's at all
    S: each device's share head(T)/8 is taken out) and by the terms of
    (c): the vocabulary-whole head of the shard's rows and the shared KV
    heads.
    (The reference's decode under tp replicates more than that, so it is
    left out.)"""
    cfg = dataclasses.replace(REDUCED_ARCHS["granite-3-2b"],
                              attn_chunk=REF_S)
    rec = dryrun.run_cell(cfg, _shape(kind, REF_S, REF_B), mesh="2x4",
                          rules_name=preset, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    dp, m, n = 2, 4, 8
    lay = spmd.Layout(cfg, dryrun.mesh_of("2x4"))
    per_row = REF_S if kind == "prefill" else 1
    head = 2 * cfg.d_model * cfg.vocab_size
    want = (reference_counts[f"{kind}|{preset}"]
            - head * REF_B * per_row / n + head * REF_B // dp
            + _kv_term(cfg, lay, REF_B // dp * per_row, m))
    assert {c["flops"] for c in rec["classes"]} == {rec["flops"]}
    assert rec["flops"] == want


# --------------------------------------------------------------------------
# (e) the collectives of a tp training step, derived by hand
# --------------------------------------------------------------------------

def _bytes(kind, g, result):
    """The reference's operand and wire bytes of a collective
    (`hlo_profile.analyze`)."""
    return {"all-gather": (result / g, result * (g - 1) / g),
            "all-reduce": (result, 2 * result * (g - 1) / g),
            "reduce-scatter": (result * g, result * g * (g - 1) / g),
            "all-to-all": (result, result * (g - 1) / g)}[kind]


def test_tp_step_collectives_equal_the_hand_sum():
    """Reduced Granite (d=64, H=4, KV=2, D=16, f=128, V=256, 2 layers) on
    (2, 2) under tp, 8 rows of 32 in 2 micro-batches: each position's
    collectives by kind. Storage (BASE_RULES): embed (V/2, d/2), head
    (d/2, V/2), the attention weights (d/2, ·/2) and (·/2, d/2), the MLP
    (d/2, f/2) and (f/2, d/2), the norms whole. Compute (TP_RULES): the
    embed and head split on V, the attention weights whole, the MLP on
    f. bf16 compute copies, 2 bytes an element; float32 scalars and
    storage gradients."""
    cfg = REDUCED_ARCHS["granite-3-2b"]
    d, V, f, L, D = 64, 256, 128, 2, 16
    q, kv = 4 * D, 2 * D
    rows, S, accum = 2, 32, 2          # a micro-batch's rows a position
    rec = dryrun.run_cell(cfg, _shape("train", S, 8, accum), mesh="2x2",
                          rules_name="tp", verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    bf, f32 = 2, 4
    calls = []
    # the step's placement of the compute copies: storage -> compute
    # blocks (all-gathers: over data for the split dims, over both axes
    # for the attention weights stored on both and whole in compute);
    # after the micro-batches their transposes land the gradients on the
    # storage blocks (reduce-scatters)
    for g, compute, stored in [
            (2, V // 2 * d, V // 2 * d // 2), (2, d * V // 2, d // 2 * V // 2),
            (4, L * d * q, L * d // 2 * q // 2), (4, L * d * kv, L * d // 2 * kv // 2),
            (4, L * d * kv, L * d // 2 * kv // 2), (4, L * q * d, L * q // 2 * d // 2),
            (2, L * d * f // 2, L * d // 2 * f // 2), (2, L * d * f // 2, L * d // 2 * f // 2),
            (2, L * f // 2 * d, L * f // 2 * d // 2)]:
        calls += [("all-gather", g, compute * bf),
                  ("reduce-scatter", g, stored * bf)]
    for _mb in range(accum):
        # the loss gathers the vocabulary-split embed table and head whole
        # over "model" (their gradients reduce-scattered back)
        for whole in (V * d, d * V):
            calls += [("all-gather", 2, whole * bf),
                      ("reduce-scatter", 2, whole // 2 * bf)]
        # wo and w_down row-parallel: a (rows, S, d) all-reduce over
        # "model" a layer, and its transpose in the backward
        calls += [("all-reduce", 2, rows * S * d * bf)] * (2 * 2 * L)
        # the NLL and the label count summed over the mesh; the NLL's
        # gradient back
        calls += [("all-reduce", 4, f32)] * 3
    # the replicated norms' gradients summed over their 4 copies, and the
    # gradients' global norm
    calls += [("all-reduce", 4, d * f32), ("all-reduce", 4, L * d * f32),
              ("all-reduce", 4, L * d * f32), ("all-reduce", 4, f32)]
    want = {}
    for kind, g, result in calls:
        operand, wire = _bytes(kind, g, result)
        w = want.setdefault(kind, {"operand_bytes": 0.0, "result_bytes": 0.0,
                                   "wire_bytes": 0.0, "count": 0.0})
        w["operand_bytes"] += operand
        w["result_bytes"] += result
        w["wire_bytes"] += wire
        w["count"] += 1
    assert [len(c["positions"]) for c in rec["classes"]] == [4]
    assert rec["collectives"] == want
    assert rec["collective_bytes"] == sum(w["operand_bytes"]
                                          for w in want.values())
    assert rec["collective_wire_bytes"] == sum(w["wire_bytes"]
                                               for w in want.values())


def test_a_count_places_and_records_its_positions_only():
    """Under a count only the counted positions hold pieces and the
    collectives over the count's mesh record themselves; another mesh's,
    and every mesh's outside the count, move their pieces."""
    mesh, other = dryrun.mesh_of("2x2"), dryrun.mesh_of("2x2")
    t = torch.empty(8, 4, device="meta")
    seen = []
    M.COUNT = M.Count(mesh, (3,), lambda *a: seen.append(a))
    try:
        y = M.place(t, M.Placement(mesh, M.P("data", "model")))
        z = M.all_gather(y, "model", 1)
        x = M.place(t, M.Placement(other, M.P("data", "model")))
        w = M.all_gather(x, "model", 1)
    finally:
        M.COUNT = None
    assert [p is None for p in y.pieces] == [True, True, True, False]
    assert [p is None for p in z.pieces] == [True, True, True, False]
    assert z.pieces[3].shape == (4, 4)
    assert all(p is not None and p.shape == (4, 4) for p in w.pieces)
    assert seen == [(3, "all-gather", 2, 4 * 4 * 4)]
    M.all_gather(M.place(t, M.Placement(mesh, M.P("data", "model"))),
                 "model", 1)
    assert len(seen) == 1


# --------------------------------------------------------------------------
# (f) the dryrun and roofline CLIs and records
# --------------------------------------------------------------------------

@pytest.fixture
def reference_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(roofline, name, getattr(jroof, name))


def _record(arch, shape, mesh, rules, kind, flops=3.1e15, **over):
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "kind": kind,
           "rules": rules, "status": "ok", "flops": flops,
           "collective_bytes": 2.5e10, "collective_wire_bytes": 4.0e10,
           "memory": {"argument_size_bytes": 7.0e9,
                      "output_size_bytes": 6.5e9,
                      "temp_size_bytes": 2.0e10}}
    rec.update(over)
    return rec


RECORDS = [
    _record("granite-3-2b", "train_4k", "16x16", "tp", "train"),
    _record("granite-3-2b", "train_4k", "16x16", "baseline", "train",
            flops=2.9e15),
    _record("granite-3-2b", "train_4k", "2x16x16", "tp", "train",
            flops=1.6e15),
    _record("qwen1.5-110b", "prefill_32k", "16x16", "tp", "prefill",
            collective_bytes=0.0),
    _record("moonshot-v1-16b-a3b", "decode_32k", "2x16x16", "baseline",
            "decode", flops=1.0e11),
    _record("rwkv6-3b", "decode_32k", "16x16", "tp", "decode",
            status="error"),
]


@pytest.mark.parametrize("mesh,rules", [("16x16", "tp"),
                                        ("16x16", "baseline"),
                                        ("2x16x16", "tp"),
                                        ("2x16x16", "baseline")])
def test_table_and_markdown_match_the_reference(tmp_path, monkeypatch,
                                                reference_constants, mesh,
                                                rules):
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(RECORDS))
    monkeypatch.setattr(roofline, "RESULTS", path)
    monkeypatch.setattr(jroof, "RESULTS", path)
    rows = roofline.table(mesh, rules)
    assert rows == jroof.table(mesh, rules) and rows
    assert roofline.markdown(rows) == jroof.markdown(rows)
    for rec in RECORDS:
        if rec["mesh"] == mesh and rec["status"] == "ok":
            assert (roofline.model_flops_per_device(rec)
                    == jroof.model_flops_per_device(rec))


def test_save_result_keys_on_arch_shape_mesh_rules(tmp_path, monkeypatch):
    monkeypatch.setattr(roofline, "RESULTS", tmp_path / "dryrun.json")
    for rec in RECORDS:
        dryrun.save_result(rec)
    dryrun.save_result(dict(RECORDS[0], flops=1.0))
    got = dryrun.load_results()
    assert len(got) == len(RECORDS)
    assert [r["flops"] for r in got if r["mesh"] == "16x16"
            and r["rules"] == "tp" and r["arch"] == "granite-3-2b"] == [1.0]
    one = {k: v for k, v in RECORDS[1].items() if k != "rules"}
    dryrun.save_result(dict(one, mesh="1", chips=1))
    dryrun.save_result(dict(one, mesh="1", chips=1, flops=5.0))
    assert [r["flops"] for r in dryrun.load_results()
            if r["mesh"] == "1"] == [5.0]


def _fake_cells(monkeypatch, tmp_path):
    monkeypatch.setattr(roofline, "RESULTS", tmp_path / "dryrun.json")
    calls = []

    def run_cell(arch, shape, *, mesh=None, rules=None,
                 rules_name="baseline", **_kw):
        calls.append((arch, shape, mesh, rules_name))
        return {"arch": arch, "shape": shape, "mesh": mesh or "1",
                "rules": rules_name, "kind": "train", "status": "ok",
                "count_s": 0.0, "flops": 1.0, "hbm_bytes": 1.0,
                "collective_bytes": 1.0}
    monkeypatch.setattr(dryrun, "run_cell", run_cell)
    return calls


def test_cli_both_meshes_and_skip_done(tmp_path, monkeypatch):
    calls = _fake_cells(monkeypatch, tmp_path)
    dryrun.main(["--arch", "granite-3-2b", "--shape", "train_4k",
                 "--both-meshes", "--rules", "tp"])
    assert calls == [("granite-3-2b", "train_4k", "16x16", "tp"),
                     ("granite-3-2b", "train_4k", "2x16x16", "tp")]
    assert sorted(r["mesh"] for r in dryrun.load_results()) == [
        "16x16", "2x16x16"]
    calls.clear()
    # per key: the same cells are skipped, another preset's are not
    dryrun.main(["--arch", "granite-3-2b", "--shape", "train_4k",
                 "--both-meshes", "--rules", "tp", "--skip-done"])
    assert calls == []
    dryrun.main(["--arch", "granite-3-2b", "--shape", "train_4k",
                 "--multi-pod", "--rules", "cp", "--skip-done"])
    assert calls == [("granite-3-2b", "train_4k", "2x16x16", "cp")]
    dryrun.main(["--arch", "granite-3-2b", "--shape", "train_4k",
                 "--one-card", "--skip-done"])
    assert calls[-1] == ("granite-3-2b", "train_4k", None, "baseline")
    assert len(dryrun.load_results()) == 4


def test_mesh_record_fields_and_its_roofline_row(tmp_path, monkeypatch):
    """A mesh cell's record: the busiest class's numbers, its chips, and
    every class beside it; the roofline reads it per device."""
    monkeypatch.setattr(roofline, "RESULTS", tmp_path / "dryrun.json")
    cfg = REDUCED_ARCHS["granite-3-2b"]
    rec = dryrun.run_cell(cfg, _shape("decode", 16, 8), mesh="2x2x2",
                          rules_name="serve8", verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert (rec["mesh"], rec["rules"], rec["chips"]) == ("2x2x2", "serve8", 8)
    assert rec["collective_bytes"] > 0 and len(rec["classes"]) == 2
    assert sorted(i for c in rec["classes"] for i in c["positions"]) == \
        list(range(8))
    busiest = max(rec["classes"], key=lambda c: dryrun._bound(
        dict(rec, **c)))
    assert rec["position"] == busiest["positions"][0]
    assert rec["flops"] == busiest["flops"]
    assert rec["memory"] == busiest["memory"]
    dryrun.save_result(dict(rec, arch="granite-3-2b", shape="decode_32k"))
    rows = roofline.table("2x2x2", "serve8")
    assert len(rows) == 1 and rows[0]["compute_s"] == \
        rec["flops"] / roofline.PEAK_FLOPS
    assert rows[0]["collective_s"] == rec["collective_bytes"] / \
        roofline.LINK_BW
    assert roofline.table("16x16", "serve8") == []
