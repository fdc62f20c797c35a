"""single_bwd_roofline: percent, the single frontend's reverse-recurrence
kernel's least time (its data-gradient multiply-adds at the card's f32
FMA rate, or its bytes at the HBM bandwidth, whichever is larger:
``perfbench.bounds.single``), averaged over the launches the program
recorded, over the kernel's mean device time in the traced window. The
launches are the program's record
(``biear_tpu_torch.models.frontend_bwd.SINGLE_LAUNCH_SHAPES``: a step's
first frame runs no filterbank VJP, its last no controller step). None
where the window ran no such kernel (a program without it, a cell
without the single frontend's backward), where the record holds more
than one frame shape, or for a card not in the peak tables."""

from perfbench import bounds, devtrace
from perfbench.bounds import frontend, single
from perfbench.metrics._shared import on_card


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not on_card(ctx):
        return None
    hit = devtrace.op_mean_s(tr["ops"], "single_bwd_kernel")
    try:
        from biear_tpu_torch.models.frontend_bwd import SINGLE_LAUNCH_SHAPES
    except ImportError:
        return None
    kind = ctx.get("device_kind")
    rate, hbm = frontend.fma_peak(kind), bounds.peak(kind, "hbm_bytes")
    if (hit is None or rate is None or hbm is None
            or len({k[:4] for k in SINGLE_LAUNCH_SHAPES}) != 1):
        return None
    n = sum(SINGLE_LAUNCH_SHAPES.values())
    least = sum(count * bounds.least_time(*single.single_bwd(*key),
                                          rate, hbm)[0]
                for key, count in SINGLE_LAUNCH_SHAPES.items()) / n
    return 100.0 * least / hit[0]
