"""replay_gap_launch_ms: per gap between two replays (as ``replay_gap_ms``,
moved to the host clock by the recorder's calibration, whose width,
``clock_width_ms``, it does not resolve below), the milliseconds of it that
a ``graph.launch`` span covers (the card waiting on the host's launch), mean
over the gaps. Read by ``_recorder.replay``; None off the card or without a
record."""

from perfbench.metrics._recorder import replay


def read(ctx):
    return replay(ctx, "gap_launch_ms")
