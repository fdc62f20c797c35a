"""replay_gap_ms: milliseconds of device time from one replay's recorded
mark to the next replay's start mark within a chunk call (the card waiting
between replays), mean over the gaps. Read by ``_recorder.replay``; None off
the card or without a record."""

from perfbench.metrics._recorder import replay


def read(ctx):
    return replay(ctx, "gap_ms")
