"""K3's share of its roofline in the traced prefill calls: the least time
of the attention each call's shape needs on K3 (the benchmark's count,
`counting.k3_bound_s`, at the card's published bf16 peak and bandwidth)
over the device time of K3's kernels in the trace, in %."""

KERNELS = ("flash_wgmma_kernel", "flash_f32_kernel")


def read(ctx):
    measured = ctx.trace.op_s(lambda n: any(k in n for k in KERNELS))
    if measured <= 0:
        return None
    bound = sum(ctx.counting.k3_bound_s(ctx.conf, s["batch"], s["length"])
                for s in ctx.traced)
    return 100.0 * bound / measured
