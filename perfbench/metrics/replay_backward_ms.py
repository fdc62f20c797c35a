"""replay_backward_ms: milliseconds per step from the forward mark to the
backward mark (after ``torch.autograd.grad``) of the captured chunk's
replays (device-timed marks), mean. Read by ``_recorder.replay``; None off
the card or without a record."""

from perfbench.metrics._recorder import replay


def read(ctx):
    return replay(ctx, "backward_ms")
