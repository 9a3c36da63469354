"""Device ms a traced prefill call under the program's `rms_norm` and
`rope` spans (`models/layers.py::rms_norm`, the rotations of
`models/transformer.py::_attn_block`): the float32 elementwise work of
the norms and rotary embeddings."""

SPANS = ("rms_norm", "rope")


def read(ctx):
    times = [ctx.trace.span_s(s) for s in SPANS]
    if None in times:
        return None
    return 1e3 * sum(times) / len(ctx.traced)
