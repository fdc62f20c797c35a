"""replay_launch_ms: host milliseconds of the chunk graph's ``graph.launch``
spans (one around each replay's launch), mean over the spans. Read by
``_recorder.replay``; None off the card or without a record."""

from perfbench.metrics._recorder import replay


def read(ctx):
    return replay(ctx, "launch_ms")
