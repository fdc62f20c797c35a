"""optimizer_busy_ms: device busy milliseconds (torch.profiler, the union of
device op intervals) of one eager optimizer stage of the cell's batch, after
one untraced call."""

from perfbench.metrics._shared import stage_ms


def read(ctx):
    return stage_ms(ctx, "optimizer")
