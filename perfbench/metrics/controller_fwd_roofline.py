"""controller_fwd_roofline: percent, the dual frontend's forward
controller kernel's least time (its multiply-adds at the card's f32 FMA
rate, or its bytes at the HBM bandwidth, whichever is larger:
``perfbench.bounds.controller``) over the kernel's mean device time in
the traced window. The shape is the program's record
(``biear_tpu_torch.models.controller.LAUNCH_SHAPES``). None where the
window ran no such kernel (a program without it, a cell without the
adaptive frontend), where the record holds more than one frame shape,
or for a card not in the peak tables."""

from perfbench import bounds, devtrace
from perfbench.bounds import controller, frontend
from perfbench.metrics._shared import on_card


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not on_card(ctx):
        return None
    hit = devtrace.op_mean_s(tr["ops"], "controller_fwd_kernel")
    try:
        from biear_tpu_torch.models.controller import LAUNCH_SHAPES
    except ImportError:
        return None
    kind = ctx.get("device_kind")
    rate, hbm = frontend.fma_peak(kind), bounds.peak(kind, "hbm_bytes")
    if hit is None or rate is None or hbm is None or len(LAUNCH_SHAPES) != 1:
        return None
    least = bounds.least_time(
        *controller.controller_fwd(*next(iter(LAUNCH_SHAPES))), rate, hbm)[0]
    return 100.0 * least / hit[0]
