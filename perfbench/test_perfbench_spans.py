"""The readers of the program's prefill spans and `span_report.py`'s split
of a traced step, against a hand-built trace (the card's runs are the
benchmark's own)."""
from __future__ import annotations

import pytest

from pbench import harness, program

program.load(harness.ROOT)

BENCH = harness.Bench()


# One traced call's device work in the order the program's prefill step
# runs it: (span, kernel us, gap us after it), the kernels of a span
# back to back; `run_blocks`' own kernels are the residual adds.
STEP_WORK = (("embed_inputs", 2, .5), ("rms_norm", 2, .5), ("qkv_proj", 4, .5),
             ("rope", 2, .5), ("flash_attention_forward", 4, .5),
             ("attn_out", 2, .5), ("run_blocks", 1, .5), ("rms_norm", 2, .5),
             ("mlp", 10, 2.5), ("run_blocks", 1, .5), ("rms_norm", 1, .5),
             ("lm_head", 1, .5), ("cache_pack", 2, 0))


def _span_trace(drop=()):
    """Two calls at 10 and 110 us with a harness kernel between them, as
    the profiler records them: a span's device mark only over the kernels
    launched while it is the innermost span (so one `run_blocks` mark a
    call, over its two residual adds, and no `prefill_step` mark), and
    on the host each span from its kernels' launch to the next span's, on
    a clock 60 us ahead of the device's (the two drift apart), so the
    second call's marks start before its host-side `prefill_step`."""
    from collections import defaultdict
    from pbench import tracing
    ahead = 60.0
    ops, marks, host = [], defaultdict(list), []
    for t0 in (10.0, 110.0):
        host += [(t0 - 1 + ahead, t0 + 50 + ahead, "prefill_step"),
                 (t0 - .5 + ahead, t0 + 38 + ahead, "run_blocks")]
        t, blocks = t0, []
        for name, us, gap in STEP_WORK:
            kernel = ("flash_wgmma_kernel<128>"
                      if name == "flash_attention_forward" else "k_" + name)
            ops.append((t, t + us, kernel))
            if name == "run_blocks":
                blocks += [t, t + us]
            else:
                marks[name].append((t, t + us))
                host.append((t + ahead, t + us + gap + ahead, name))
            t += us + gap
        marks["run_blocks"].append((min(blocks), max(blocks)))
    ops.append((60.0, 65.0, "k_harness"))
    for name in drop:
        marks.pop(name, None)
        host = [h for h in host if h[2] != name]
    ops.sort()
    return tracing.Trace(window_s=130e-6, ops=ops, span_ops=list(ops),
                         marks=dict(marks), host=sorted(host))


SPAN_READERS = ("step_idle.prefill", "norm_rope_ms.prefill",
                "attn_proj_ms.prefill", "mlp_ms.prefill",
                "cache_pack_ms.prefill")


def _read(name, trace):
    from types import SimpleNamespace
    ctx = SimpleNamespace(trace=trace, traced=[{}, {}])
    return BENCH.reader(name).read(ctx)


def test_span_readers_against_a_hand_built_trace():
    """Each call: 34 us of kernels over a 42 us step with 8 us of gaps;
    norms 5 + rotations 2, projections 4 + 2, MLP 10, cache 2 us."""
    tr = _span_trace()
    got = {name: _read(name, tr) for name in SPAN_READERS}
    assert got == {"step_idle.prefill": pytest.approx(100 * 8 / 42),
                   "norm_rope_ms.prefill": pytest.approx(7e-3),
                   "attn_proj_ms.prefill": pytest.approx(6e-3),
                   "mlp_ms.prefill": pytest.approx(10e-3),
                   "cache_pack_ms.prefill": pytest.approx(2e-3)}
    # the harness's kernel and the gaps around it are outside both steps
    assert BENCH.reader("step_idle.prefill").steps(tr) == [(10.0, 52.0),
                                                           (110.0, 152.0)]


@pytest.mark.parametrize("drop,silent", [
    (("prefill_step", "run_blocks", "embed_inputs", "rms_norm", "qkv_proj",
      "rope", "flash_attention_forward", "attn_out", "mlp", "lm_head",
      "cache_pack"), SPAN_READERS),
    (("rope",), ("norm_rope_ms.prefill",)),
    (("attn_out",), ("attn_proj_ms.prefill",)),
    (("mlp", "cache_pack"), ("mlp_ms.prefill", "cache_pack_ms.prefill")),
    (("prefill_step",), ("step_idle.prefill",))])
def test_span_readers_read_nothing_where_their_span_is_absent(drop, silent):
    """A program without the spans (the first case: no span at all) reads
    None, and each reader falls silent only with its own spans."""
    tr = _span_trace(drop)
    for name in SPAN_READERS:
        assert (_read(name, tr) is None) == (name in silent), name


def test_span_report_splits_the_step_by_span():
    import span_report
    out = span_report.breakdown(
        _span_trace(), 2, BENCH.reader("step_idle.prefill"),
        BENCH.reader("k3_roofline.prefill").KERNELS)
    assert out["steps_found"] == 2
    assert out["span_ms"] == pytest.approx({
        "embed_inputs": 2e-3, "rms_norm": 5e-3, "qkv_proj": 4e-3,
        "rope": 2e-3, "flash_attention_forward": 4e-3, "attn_out": 2e-3,
        "mlp": 10e-3, "lm_head": 1e-3, "cache_pack": 2e-3})
    assert out["k3_ms"] == pytest.approx({
        "by_name_device_slice": 4e-3, "by_name_host_slice": 4e-3,
        "span": 4e-3})
    assert out["span_names_among_device_ops"] == []
    assert out["step_device_ms"] == pytest.approx(34e-3)
    assert out["covered_share"] == pytest.approx(32 / 34)
    assert out["unspanned_ms"] == pytest.approx(2e-3)
    assert out["idle_ms_inside_steps"] == pytest.approx(8e-3)
    # each gap by the span of the kernel after it: the residual add after
    # the MLP's 2.5 us gap is `run_blocks`' own
    assert out["idle_ms_inside_by_span"] == pytest.approx({
        "run_blocks": 3e-3, "rms_norm": 1.5e-3, "qkv_proj": .5e-3,
        "rope": .5e-3, "flash_attention_forward": .5e-3, "attn_out": .5e-3,
        "mlp": .5e-3, "lm_head": .5e-3, "cache_pack": .5e-3})
    # 52 -> 60 and 65 -> 110 us, over two calls
    assert out["idle_ms_between_calls"] == pytest.approx(26.5e-3)
