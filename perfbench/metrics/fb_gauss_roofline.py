"""fb_gauss_roofline: percent, the adaptive filterbank kernel's least time
(its exponentials at the card's exp rate, or the bytes of its bf16 rhs, Q
and outputs at the HBM bandwidth, whichever is larger:
``perfbench.bounds.filterbank``) over its mean device time in the traced
window. The shape is the program's record of its launches
(``biear_tpu_torch.ops.filterbank.LAUNCH_SHAPES``). None where the window
ran no such kernel (a program without it, a cell without the adaptive
filterbank), where it ran at more than one shape, or for a card not in
the peak tables."""

from perfbench import bounds, devtrace
from perfbench.bounds import filterbank
from perfbench.metrics._shared import on_card


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not on_card(ctx):
        return None
    hit = devtrace.op_mean_s(tr["ops"], "fb_gauss_kernel")
    try:
        from biear_tpu_torch.ops.filterbank import LAUNCH_SHAPES
    except ImportError:
        return None
    kind = ctx.get("device_kind")
    rate, hbm = filterbank.exp_peak(kind), bounds.peak(kind, "hbm_bytes")
    if hit is None or len(LAUNCH_SHAPES) != 1 or rate is None or hbm is None:
        return None
    exps, nbytes = filterbank.fb_gauss(*next(iter(LAUNCH_SHAPES)))
    return 100.0 * bounds.least_time(exps, nbytes, rate, hbm)[0] / hit[0]
