"""spectra_roofline: percent, the frame spectra kernel's least time (its
FFT's operations at the card's f32 rate, or its bytes at the HBM
bandwidth, whichever is larger: ``perfbench.bounds.spectra``), averaged
over the launches the program recorded, over the kernel's mean device
time in the traced window. The launches are the program's record
(``biear_tpu_torch.ops.spectra.LAUNCH_SHAPES``: rows, frames, samples a
frame, bins and the output form). None where the window ran no such
kernel (a program without it, a policy that keeps the product or the
rFFT) or for a card not in the peak tables."""

from perfbench import bounds, devtrace
from perfbench.bounds import spectra
from perfbench.metrics._shared import on_card


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not on_card(ctx):
        return None
    hit = devtrace.op_mean_s(tr["ops"], "spectra_kernel")
    try:
        from biear_tpu_torch.ops.spectra import LAUNCH_SHAPES
    except ImportError:
        return None
    kind = ctx.get("device_kind")
    rate, hbm = bounds.peak(kind, "f32_flops"), bounds.peak(kind, "hbm_bytes")
    n = sum(LAUNCH_SHAPES.values())
    if hit is None or rate is None or hbm is None or n == 0:
        return None
    least = sum(count * bounds.least_time(*spectra.spectra(*key), rate,
                                          hbm)[0]
                for key, count in LAUNCH_SHAPES.items()) / n
    return 100.0 * least / hit[0]
