"""The share of the traced slice of prefill calls in which no operation
ran on the card: 1 - (union of device operations) / the slice's length,
in %."""


def read(ctx):
    busy = ctx.trace.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / ctx.trace.window_s)
