"""The frame spectra: each frame's windowed DFT, and the adaptive
filterbank's operand built from both ears' spectra.

Counterpart of the spectra in ``biear_tpu/models/frontend.py``, where the
bf16 policy takes them as an f32 product of the frames against the
windowed DFT bases (plain XLA). The plain path here is that product,
``dft_plain``, and the stack of [mag, re, im, 1] of both ears on the rows,
``rhs_plain``. On a CUDA tensor ``spectra_cuda`` and ``rhs_cuda`` run one
launch of ``kernels/spectra.cu`` instead: the frames read in place from
the waveform, windowed, transformed by a real FFT in f32 and written in
the form the reader takes (the bf16 rhs of both ears, or the f32 spectra
of one ear, or its magnitudes alone). The frontend dispatches
(``models/frontend.py::spectra_on_kernel``); a build or launch failure
raises, and nothing falls back.

The waveforms are data: the kernel has no backward, and refuses frames
that require a gradient.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..device import precision_highest
from ..kernels import count_launch
from .filterbank import stack_rhs

# (rows, T, win, F, form) -> launches, form "rhs" (both ears' bf16
# operand: rows 2B), "xs" (f32 mag, re, im) or "mag" (f32 mag alone)
LAUNCH_SHAPES: collections.Counter = collections.Counter()

MAX_FFT = 4096


def fft_twiddles(n_fft: int) -> dict:
    """The twiddles of ``spectra.cu``'s real FFT, built in float64 and
    rounded to float32 complex (re, im) pairs: "fft_tw", e^{-2i pi j / M}
    of its M = n_fft / 2-point transform, and "rfft_tw", e^{-2i pi k /
    n_fft} of the split into the bins k <= M."""
    m = n_fft // 2
    turn = lambda n, d: np.exp(-2j * np.pi * np.arange(n) / d)
    pairs = lambda z: np.stack([z.real, z.imag], -1).astype(np.float32)
    return {"fft_tw": pairs(turn(m, m)), "rfft_tw": pairs(turn(m + 1, n_fft))}


def dft_plain(frames: torch.Tensor, dft_re: torch.Tensor,
              dft_im: torch.Tensor) -> tuple:
    """frames (..., win) -> (Xmag, Xre, Xim), each (..., F): the windowed
    DFT bases as one f32 product each (TF32 off on the card, under every
    MATMUL_PRECISION)."""
    with precision_highest():
        re = frames @ dft_re
        im = frames @ dft_im
    return torch.sqrt(re * re + im * im), re, im


def rhs_plain(specL: tuple, specR: tuple, bf16: bool) -> torch.Tensor:
    """Both ears' filterbank operand from their (Xmag, Xre, Xim): [mag, re,
    im, 1] stacked on the rows, left ear first, the frame axis moved first
    where there is one: (T, 2B, 4, F) from (B, T, F) spectra (a
    transposed view of the (2B, T, 4, F) stack), (2B, 4, F) from (B, F)."""
    rhs = torch.cat([stack_rhs(*specL, bf16), stack_rhs(*specR, bf16)])
    return rhs.transpose(0, 1) if rhs.dim() == 4 else rhs


def _frames3(frames: torch.Tensor, c: dict, n_fft: int) -> torch.Tensor:
    """frames (B, T, win) or (B, win) as a (B, T, win) view, checked for
    the kernel: float32, no gradient, contiguous samples, win of c's
    window, n_fft a power of two up to MAX_FFT, and on the CUDA device
    that holds c's window and twiddles."""
    if frames.dim() not in (2, 3):
        raise ValueError("spectra needs frames (B, T, win) or (B, win), got "
                         f"{tuple(frames.shape)}")
    if frames.dtype != torch.float32:
        raise TypeError(f"spectra takes float32 frames, got {frames.dtype}")
    if frames.requires_grad:
        raise ValueError("spectra's kernel has no backward: the frames must "
                         "not require a gradient")
    if frames.stride(-1) != 1:
        raise ValueError("spectra needs frames with contiguous samples, got "
                         f"strides {frames.stride()}")
    win = c["window"].shape[0]
    if frames.shape[-1] != win or min(frames.shape) <= 0:
        raise ValueError(f"spectra needs non-empty frames of {win} samples, "
                         f"got {tuple(frames.shape)}")
    if not (2 <= n_fft <= MAX_FFT and n_fft & (n_fft - 1) == 0):
        raise ValueError(f"spectra needs n_fft a power of two from 2 to "
                         f"{MAX_FFT}, got {n_fft}")
    if not frames.is_cuda or any(c[k].device != frames.device
                                 for k in ("window", "fft_tw", "rfft_tw")):
        raise ValueError("spectra_cuda needs the frames and the constants on "
                         "one CUDA device")
    f3 = frames if frames.dim() == 3 else frames[:, None]
    if max(f3.stride()) >= 2 ** 31:
        raise ValueError("spectra needs strides below 2**31 elements")
    return f3


def _launch(fl: torch.Tensor, fr: torch.Tensor | None, c: dict, n_fft: int,
            rhs=None, mag=None, re=None, im=None) -> None:
    from ..kernels.build import check_launch, spectra_lib

    ears = 1 if fr is None else 2
    fr = fl if fr is None else fr
    B, T, win = fl.shape
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(fl.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = spectra_lib().spectra_launch(
            fl.data_ptr(), fl.stride(0), fl.stride(1), fr.data_ptr(),
            fr.stride(0), fr.stride(1), B, ears, T, win, n_fft,
            c["window"].data_ptr(), c["fft_tw"].data_ptr(),
            c["rfft_tw"].data_ptr(), ptr(rhs), ptr(mag), ptr(re), ptr(im),
            stream)
    check_launch(err, "spectra")
    count_launch("spectra")
    form = "rhs" if rhs is not None else ("mag" if re is None else "xs")
    LAUNCH_SHAPES[(ears * B, T, win, n_fft // 2 + 1, form)] += 1


def spectra_cuda(frames: torch.Tensor, c: dict, n_fft: int,
                 mag_only: bool = False) -> tuple:
    """One ear's spectra as one launch of ``spectra.cu`` on the current
    stream: frames (..., win) -> (Xmag, Xre, Xim), each (..., F) float32;
    with `mag_only`, (Xmag, None, None). c: the frontend's device
    constants (the window and the FFT's twiddles)."""
    f3 = _frames3(frames, c, n_fft)
    F = n_fft // 2 + 1
    out = [torch.empty((*f3.shape[:2], F), dtype=torch.float32,
                       device=f3.device) for _ in range(1 if mag_only else 3)]
    _launch(f3, None, c, n_fft, mag=out[0], re=None if mag_only else out[1],
            im=None if mag_only else out[2])
    shape = (*frames.shape[:-1], F)
    out = [x.view(shape) for x in out]
    return (out[0], None, None) if mag_only else tuple(out)


def rhs_cuda(framesL: torch.Tensor, framesR: torch.Tensor, c: dict,
             n_fft: int) -> torch.Tensor:
    """rhs_plain of both ears' bf16 spectra as one launch of ``spectra.cu``
    on the current stream: frames (B, T, win) each -> (T, 2B, 4, F), a
    transposed view of the (2B, T, 4, F) stack, as rhs_plain gives;
    frames (B, win) -> (2B, 4, F)."""
    fl, fr = _frames3(framesL, c, n_fft), _frames3(framesR, c, n_fft)
    if fl.shape != fr.shape or fl.device != fr.device:
        raise ValueError("spectra needs both ears' frames of one shape on "
                         f"one device, got {tuple(framesL.shape)} and "
                         f"{tuple(framesR.shape)}")
    B, T = fl.shape[:2]
    rhs = torch.empty((2 * B, T, 4, n_fft // 2 + 1), dtype=torch.bfloat16,
                      device=fl.device)
    _launch(fl, fr, c, n_fft, rhs=rhs)
    return rhs.transpose(0, 1) if framesL.dim() == 3 else rhs[:, 0]
