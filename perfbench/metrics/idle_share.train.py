"""idle_share.train: percent of the traced training window (whole chunks)
in which no device op ran, from torch.profiler."""

from perfbench.metrics._shared import idle_share


def read(ctx):
    return idle_share(ctx, "train")
