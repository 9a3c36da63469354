"""Device ms a traced prefill call under the program's `qkv_proj` and
`attn_out` spans (`models/transformer.py::_project_qkv`, with its bias
adds, and `_attn_block`'s output reshape and product): the attention's
projections."""

SPANS = ("qkv_proj", "attn_out")


def read(ctx):
    times = [ctx.trace.span_s(s) for s in SPANS]
    if None in times:
        return None
    return 1e3 * sum(times) / len(ctx.traced)
