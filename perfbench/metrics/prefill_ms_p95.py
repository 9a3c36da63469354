"""The 95th percentile of every prefill call of the window, each timed on
the host's clock from the call to `synchronize()`, in ms."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.stats["call_s"], 95)) * 1e3
