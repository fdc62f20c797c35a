"""What the readers of the port's recorder (``biear_tpu_torch.trace``)
share (not a metric: no entry names it). Each returns None off the card
(``_shared.on_card``) and where the program has no recorder or the
recorder holds nothing to read."""

from perfbench.metrics._shared import on_card


def _recorder(ctx):
    if not on_card(ctx):
        return None
    try:
        from biear_tpu_torch import trace
    except ImportError:
        return None
    return trace


def replay(ctx, key: str):
    """`key` of the recorder's ``replay_summary`` over the chunk calls made
    while the profiler recorded, at their full chunk_steps and past the
    call that captured (in the traced run, the traced window's chunks)."""
    trace = _recorder(ctx)
    summary = trace.replay_summary(profiled=True) if trace else None
    return None if summary is None else summary[key]


def span_s(ctx, *names: str):
    """Seconds in every span of `names` the process recorded."""
    trace = _recorder(ctx)
    ns = trace.total_ns(*names) if trace else None
    return None if ns is None else ns / 1e9
