"""setup_capture_s: seconds of set-up in the captured chunk's eager warm-up
steps and its capture: the sum of the program's ``graph.warm_up`` and
``graph.capture`` spans. Read by ``_recorder.span_s``; None off the card or
without a record."""

from perfbench.metrics._recorder import span_s


def read(ctx):
    return span_s(ctx, "graph.warm_up", "graph.capture")
