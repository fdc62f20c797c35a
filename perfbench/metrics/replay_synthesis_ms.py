"""replay_synthesis_ms: milliseconds per step from the start mark to the
synthesis mark of the captured chunk's replays (device-timed marks), mean.
Read by ``_recorder.replay``; None off the card or without a record."""

from perfbench.metrics._recorder import replay


def read(ctx):
    return replay(ctx, "synthesis_ms")
