"""replay_frontend_grad_ms: milliseconds per step from the frontend_grad
mark (the gradient of the frontend's outputs complete) to the backward
mark of the captured chunk's replays (device-timed marks): the frontend's
own backward, mean over the records that wrote the frontend marks. None
off the card, without a record, or where the program writes no frontend
mark (AuralNet; a program without it)."""

from perfbench.metrics._recorder import _recorder


def read(ctx):
    trace = _recorder(ctx)
    summary = trace.replay_summary(profiled=True) if trace else None
    return None if summary is None else summary.get("frontend_grad_ms")
