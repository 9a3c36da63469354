"""Seconds from the process's start to the window's first call: imports,
the card's context, the weights drawn on the card, the warm-up calls and,
on a checkout's first run, the nvcc build of the port's kernels."""


def read(ctx):
    return ctx.setup_s
