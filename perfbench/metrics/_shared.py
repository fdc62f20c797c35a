"""Helpers the metric readers share (not a metric: no entry names it)."""

from perfbench import bounds, devtrace


def on_card(ctx) -> bool:
    """Whether the run measured a card (a CPU run reads no device metric)."""
    return ctx.get("device_kind", "cpu") != "cpu"


def idle_share(ctx, kind):
    """Percent of the traced window's wall time with no device op running
    (1 - busy / wall), for cells of `kind`."""
    tr = ctx.get("trace")
    if ctx.get("kind") != kind or not tr or tr["wall_s"] <= 0 \
            or not on_card(ctx):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])


def stage_ms(ctx, stage):
    if not on_card(ctx):
        return None
    return (ctx.get("stages_busy_ms") or {}).get(stage)


def roofline(ctx, kernel, fragment, flop_key):
    """Percent: the kernel's least time (bounds) over its mean device time
    in the traced window; None where the window ran no such kernel or the
    card has no peaks in the table."""
    tr, shape = ctx.get("trace"), (ctx.get("shapes") or {}).get(kernel)
    if not tr or not shape:
        return None
    hit = devtrace.op_mean_s(tr["ops"], fragment)
    rate = bounds.peak(ctx.get("device_kind"), flop_key)
    hbm = bounds.peak(ctx.get("device_kind"), "hbm_bytes")
    if hit is None or rate is None or hbm is None:
        return None
    flops, nbytes = getattr(bounds, kernel)(**shape)
    return 100.0 * bounds.least_time(flops, nbytes, rate, hbm)[0] / hit[0]
