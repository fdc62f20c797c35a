"""cc_lags_roofline: percent, the CC kernel's least time (float32
operations at the f32 peak, or bytes at the HBM bandwidth, whichever is
larger) over its mean device time in the traced window."""

from perfbench.metrics._shared import roofline


def read(ctx):
    return roofline(ctx, "cc_lags", "cc_lags_kernel", "f32_flops")
