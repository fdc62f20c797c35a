"""The adaptive filterbank kernel's yardstick: its exponentials and bytes
from its shape, and the card's rate of exponentials.

``biear_tpu_torch/kernels/fb_gauss.cu`` computes one Gaussian value, one
expf, for every (row, band, bin) and contracts it against the frame's
bf16 rhs [|X|, re, im, 1]. Its least time is the larger of the
exponentials at the card's exp rate and its bytes at the HBM bandwidth
(``perfbench.bounds.least_time``).
"""

from __future__ import annotations

# One expf is one MUFU.EX2: 16 a clock on each SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0) x 132
# SMs x 1,980 MHz, the H100 SXM's boost clock.
EXP_PEAKS = {"NVIDIA H100 80GB HBM3": 132 * 16 * 1.98e9}


def exp_peak(kind: str):
    """Exponentials a second of card `kind`, or None for a card not in the
    table."""
    return EXP_PEAKS.get(kind)


def fb_gauss(rows: int, bands: int, bins: int, with_t: bool) -> tuple:
    """(exponentials, bytes) of one launch: an expf per (row, band, bin);
    the bf16 rhs (rows, 4, bins) and Q (rows, bands) float32 read once;
    Y, Zre, Zim, den and bw (float32), the finite mask (one byte) and, with
    T, T (rows, bands, 4) float32 written once."""
    exps = float(rows) * bands * bins
    out_bytes = rows * bands * (5 * 4 + 1 + (16 if with_t else 0))
    nbytes = rows * 4 * bins * 2.0 + rows * bands * 4 + out_bytes
    return exps, float(nbytes)
