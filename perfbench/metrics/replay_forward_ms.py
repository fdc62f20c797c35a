"""replay_forward_ms: milliseconds per step from the synthesis mark to the
forward mark (after ``model_loss``) of the captured chunk's replays
(device-timed marks), mean. Read by ``_recorder.replay``; None off the card
or without a record."""

from perfbench.metrics._recorder import replay


def read(ctx):
    return replay(ctx, "forward_ms")
