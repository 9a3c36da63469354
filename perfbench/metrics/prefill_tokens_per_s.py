"""Every prompt position prefilled in the window over the window's
seconds, on the host's clock."""


def read(ctx):
    s = ctx.stats
    return s["tokens"] / s["seconds"]
