"""Model FLOPs of the window's prefill calls (the benchmark's count from
the configuration's shapes and each call's, `counting.prefill_flops`)
over the window's seconds, as a share of the card's bf16 peak, in %."""


def read(ctx):
    c = ctx.counting
    flops = sum(c.prefill_flops(ctx.conf, s["batch"], s["length"])
                for s in ctx.stats["shapes"])
    return 100.0 * flops / ctx.stats["seconds"] / c.PEAK_BF16_FLOPS
