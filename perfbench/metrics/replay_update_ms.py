"""replay_update_ms: milliseconds per step from the backward mark to the
recorded mark (the update, its telemetry and the metric row) of the captured
chunk's replays (device-timed marks), mean. Read by ``_recorder.replay``;
None off the card or without a record."""

from perfbench.metrics._recorder import replay


def read(ctx):
    return replay(ctx, "update_ms")
