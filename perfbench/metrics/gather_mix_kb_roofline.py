"""gather_mix_kb_roofline: percent, the fused gather + HRIR mix kernel's
least time (bfloat16 tensor-core operations, or the bytes of the pool
spans, the used measurements' Toeplitz tiles and the output, whichever
is larger) over its mean device time in the traced window."""

from perfbench.metrics._shared import roofline


def read(ctx):
    return roofline(ctx, "gather_mix_kb", "gather_mix_kb_kernel",
                    "bf16_flops")
