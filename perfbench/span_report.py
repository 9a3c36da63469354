"""Where a traced slice of a prefill cell spends the card's time, by the
program's spans: the device ms a call under each span of the step, the
share of the step's device time they cover, the idle inside the step by
the span of the kernel each gap waited for, the idle between calls, K3
by kernel name beside its span, and what tracing costs.

    python3 perfbench/span_report.py --workload qwen2-vl-7b.prefill \\
        --seed 3000000001 [--seconds 5] [--out trace.json.gz]

from the root of a checkout, on the card. Sets the cell up as `run.py`
does, runs a short window, then the same number of calls as the cell's
traced slice with no profiler, with the device alone recorded and with
the host too, and prints one JSON object (its "readers": the cell's
per-layer metrics and `SPAN_METRICS`); ``--out`` also writes the
traced slice (`pbench.tracing.Trace`'s lists) as gzipped JSON. On a
checkout whose program has no spans the span figures are null.
"""
from __future__ import annotations

import argparse
import bisect
import gzip
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace

import torch

from pbench import counting, harness, program, tracing

ROOT = Path(__file__).resolve().parents[1]
# readers in `metrics/` of the program's prefill spans, read here whether
# or not `BENCHMARK.json` names them
SPAN_METRICS = ("step_idle.prefill", "norm_rope_ms.prefill",
                "attn_proj_ms.prefill", "mlp_ms.prefill",
                "cache_pack_ms.prefill")


def _idle_in(gaps, extents):
    """Seconds of ``gaps`` (us) inside the ``extents`` (us), and the
    inside part of each gap, (lo, hi)."""
    parts = [(max(a, lo), min(b, hi)) for lo, hi in extents
             for a, b in gaps if min(b, hi) > max(a, lo)]
    return sum(b - a for a, b in parts) / 1e6, parts


def breakdown(trace, n_calls: int, step_spans, k3_kernels) -> dict:
    """The slice's figures a call, in ms; ``step_spans`` is the reader
    `metrics/step_idle.prefill.py`, ``k3_kernels`` K3's kernel names."""
    extents = step_spans.steps(trace)

    def ms(seconds):
        return None if seconds is None else 1e3 * seconds / n_calls
    leaves = [n for n in step_spans.INSIDE if n != "run_blocks"]
    by_span = {n: ms(trace.span_s(n)) for n in leaves}
    k3 = {"by_name_device_slice": ms(trace.op_s(
              lambda n: any(k in n for k in k3_kernels))),
          "by_name_host_slice": ms(sum(
              e - s for s, e, n in trace.span_ops
              if any(k in n for k in k3_kernels)) / 1e6),
          "span": by_span["flash_attention_forward"]}
    out = {"calls": n_calls, "steps_found": len(extents), "span_ms": by_span,
           "k3_ms": k3, "span_names_among_device_ops": sorted(
               {n for _, _, n in trace.ops}
               & {step_spans.STEP, *step_spans.INSIDE})}
    gaps = trace.gaps()
    idle_s = sum(b - a for a, b in gaps) / 1e6
    out["idle_ms_all"] = ms(idle_s)
    if not extents:
        return out
    starts = [s for s, _, _ in trace.span_ops]
    step_s = sum(e - s for lo, hi in extents for s, e, _ in trace.span_ops[
        bisect.bisect_left(starts, lo):bisect.bisect_left(starts, hi)]) / 1e6
    covered = sum(v for v in by_span.values() if v is not None)
    inside_s, parts = _idle_in(gaps, extents)
    # a gap inside a step goes to the innermost span whose mark holds the
    # kernel after it, the launch the device waited for (the host's and
    # the device's clocks drift apart, so not to what the host did then)
    tiers = [sorted((a, b, n) for n in names for a, b in
                    trace.marks.get(n, ())) for names in
             (leaves, ["run_blocks"], [step_spans.STEP])]
    idle_by = defaultdict(float)
    for lo, hi in parts:
        name = step_spans.STEP
        for marks in tiers:
            i = bisect.bisect_right(marks, (hi, float("inf"), "")) - 1
            if i >= 0 and marks[i][1] >= hi:
                name = marks[i][2]
                break
        idle_by[name] += (hi - lo) / 1e3 / n_calls
    out.update(step_device_ms=ms(step_s),
               step_ms=ms(sum(hi - lo for lo, hi in extents) / 1e6),
               covered_share=covered / ms(step_s),
               unspanned_ms=ms(step_s) - covered,
               idle_ms_inside_steps=ms(inside_s),
               idle_ms_inside_by_span=dict(sorted(
                   idle_by.items(), key=lambda kv: -kv[1])),
               idle_ms_between_calls=ms(idle_s - inside_s))
    return out


def _span_us(n: int = 20000) -> dict:
    """Host us of one entry and exit of an empty span, with no profiler
    and with the host and device recorded."""
    try:
        from repro_torch.spans import span
    except ImportError:
        return {}
    from torch.profiler import ProfilerActivity, profile

    def per():
        t = time.perf_counter()
        for _ in range(n):
            with span("x"):
                pass
        return (time.perf_counter() - t) / n * 1e6
    off = per()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = per()
    return {"off": off, "on": on}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    from torch.profiler import ProfilerActivity
    program.load(ROOT)
    bench = harness.Bench(ROOT)
    wl = bench.workload(args.workload)
    conf, mix = bench.config(wl["config"]), bench.traffic(wl["traffic"])
    program.set_precision()
    drv = bench.driver(mix["driver"]).Driver(
        conf, mix, args.seed, "cuda", bench.reference(conf["family"]))
    drv.setup()
    drv.window(args.seconds)
    n = mix["traced_rounds"] * len(mix["shapes"])

    def calls():
        first = drv.next_index
        drv.next_index += n
        for i in range(first, first + n):
            drv.timed_call(i)
    call_s = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    calls()
    call_s["untraced"] = (time.perf_counter() - t) / n
    tr = drv.trace()
    call_s["device_recorded"] = tr.window_s / n
    _, window_s = tracing._profiled(
        calls, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    call_s["host_recorded"] = window_s / n
    ctx = SimpleNamespace(conf=conf, mix=mix, stats=drv.stats, trace=tr,
                          traced=drv.traced, counting=counting,
                          setup_s=None)
    names = [m["name"] for m in bench.per_layer(args.workload)]
    readers = {n: bench.reader(n).read(ctx)
               for n in names + [n for n in SPAN_METRICS if n not in names]}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = {"card": card, "seed": args.seed, "call_s": call_s,
           "span_us": _span_us(), "readers": readers,
           "breakdown": breakdown(
               tr, len(drv.traced), bench.reader("step_idle.prefill"),
               bench.reader("k3_roofline.prefill").KERNELS),
           "device_ops": tr.top_ops(12), "idle_gaps": tr.idle_gaps(12)}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with gzip.open(args.out, "wt") as f:
            json.dump({"window_s": tr.window_s, "ops": tr.ops,
                       "span_ops": tr.span_ops, "marks": tr.marks,
                       "host": tr.host, "traced": drv.traced}, f)
    drv.release()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
