"""Device ms a traced prefill call under the program's `mlp` span
(`models/transformer.py::_mlp`): the gate, up and down products, the
activation and the gate's multiply."""


def read(ctx):
    t = ctx.trace.span_s("mlp")
    return None if t is None else 1e3 * t / len(ctx.traced)
