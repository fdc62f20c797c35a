"""The frame spectra kernel's yardstick: its operations and bytes from
its shape.

``biear_tpu_torch/kernels/spectra.cu`` reads each frame's samples from
the waveform, windows them, takes their real FFT in f32 and writes the
spectra in the form its reader takes: the adaptive frontends' bf16
operand [mag, re, im, 1] of both ears, or one ear's f32 (mag, re, im), or
its f32 mag alone. Its least time is the larger of its operations at the
card's f32 rate and its bytes at the HBM bandwidth
(``perfbench.bounds.least_time``).
"""

from __future__ import annotations

import math

# output bytes a bin, by the form the program records
FORM_BYTES = {"rhs": 4 * 2, "xs": 3 * 4, "mag": 4}


def frame_ops(win: int, bins: int) -> float:
    """Operations of one frame: the window (a multiply a sample), the
    complex FFT of M = bins - 1 points by the usual count, 5 M log2 M, and
    per bin the split into the real spectrum (16) and the magnitude
    (4)."""
    m = bins - 1
    return win + 5.0 * m * math.log2(m) + 20.0 * bins


def spectra(rows: int, frames: int, win: int, bins: int,
            form: str) -> tuple:
    """(operations, bytes) of one launch over `rows` rows of `frames`
    frames of `win` samples and `bins` bins: each sample read once
    (float32), each output byte written once in `form` ("rhs", "xs" or
    "mag", FORM_BYTES)."""
    n = float(rows) * frames
    return n * frame_ops(win, bins), n * (4.0 * win + FORM_BYTES[form] * bins)
