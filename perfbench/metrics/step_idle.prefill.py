"""The share of the traced prefill calls' steps on the device in which
no device operation of the host slice runs, in %: the idle the program
causes itself, with the harness's gaps between calls left out.

The profiler marks a span on the device only over the kernels launched
while it is the innermost open span (`repro_torch/spans.py`), so the
mark of `prefill_step`, whose work runs in its child spans, does not
cover the step. A call's step on the device is therefore the hull of
the marks of `prefill_step` and of every span inside it. The host's and
the device's timestamps drift apart (~1.4 ms a second on an H100), so a
mark is not given to a call by its time: the k-th mark of a span is the
k-th entry of that span on the host, which lies inside one call's
host-side `prefill_step`. A span whose marks and entries differ in
number (an entry that launched no kernel) is left out of the hull."""
import bisect

STEP = "prefill_step"
INSIDE = ("run_blocks", "embed_inputs", "rms_norm", "qkv_proj", "rope",
          "flash_attention_forward", "attn_out", "mlp", "lm_head",
          "cache_pack")


def steps(trace):
    """Each traced call's step on the device, (start us, end us), in
    order; [] where the slice never entered `prefill_step`."""
    entries = {}
    for s, _, n in trace.host:
        entries.setdefault(n, []).append(s)
    calls = sorted(entries.get(STEP, ()))
    lo = [float("inf")] * len(calls)
    hi = [float("-inf")] * len(calls)
    for name in (STEP,) + INSIDE:
        marks = sorted(trace.marks.get(name, ()))
        host = sorted(entries.get(name, ()))
        if len(marks) != len(host):
            continue
        for (a, b), h in zip(marks, host):
            i = bisect.bisect_right(calls, h) - 1
            if i >= 0:
                lo[i], hi[i] = min(lo[i], a), max(hi[i], b)
    return [(a, b) for a, b in zip(lo, hi) if a < b]


def read(ctx):
    extents = steps(ctx.trace)
    if not extents:
        return None
    gaps = ctx.trace.gaps()
    idle = sum(max(0.0, min(b, hi) - max(a, lo))
               for lo, hi in extents for a, b in gaps)
    return 100.0 * idle / sum(hi - lo for lo, hi in extents)
