"""Kept-lag binaural cross-correlation: the CUDA kernel's dispatch.

Counterpart of ``biear_tpu/ops/window_gather.py::cc_kept_lags``. The
tensor's device picks the implementation: a CUDA tensor launches the
hand-written kernel ``kernels/cc_lags.cu``, a CPU tensor takes the plain
version ``ops.xcorr.cc_kept_lags_plain``. A kernel that fails to build or
launch raises; it never falls back.

The other two TPU kernels of that module (``_mix_kernel``,
``_window_kernel``) belong to on-device training synthesis and are not
ported yet.
"""

from __future__ import annotations

import torch

from ..kernels import LAUNCHES

MAX_KEPT = 63          # the lag window 2K+1 must fit the kernel's 128 lags


def _check(lf: torch.Tensor, rf: torch.Tensor, max_kept: int) -> None:
    if lf.ndim != 2 or lf.shape != rf.shape:
        raise ValueError(f"cc kernel needs two (B, n) tensors of one shape, "
                         f"got {tuple(lf.shape)} and {tuple(rf.shape)}")
    n = lf.shape[1]
    if not (n % 128 == 0 and 0 < max_kept <= MAX_KEPT):
        raise ValueError(f"cc kernel needs n%128==0 and max_kept<={MAX_KEPT}, "
                         f"got n={n}, max_kept={max_kept}")


def cc_kept_lags_cuda(lf: torch.Tensor, rf: torch.Tensor,
                      max_kept: int) -> torch.Tensor:
    """Launch ``cc_lags.cu`` on the current stream: (B, n) x2 -> (B, 2K+1)."""
    from ..kernels.build import cc_lags_lib, check_launch

    _check(lf, rf, max_kept)
    if not (lf.is_cuda and rf.is_cuda and lf.device == rf.device):
        raise ValueError("cc_kept_lags_cuda needs both inputs on one CUDA "
                         "device")
    if lf.dtype != torch.float32 or rf.dtype != torch.float32:
        raise TypeError(f"cc kernel takes float32, got {lf.dtype}/{rf.dtype}")
    lf, rf = lf.contiguous(), rf.contiguous()
    B, n = lf.shape
    lib = cc_lags_lib()
    partial = torch.empty(int(lib.cc_lags_partial_floats(B, n, max_kept)),
                          dtype=torch.float32, device=lf.device)
    out = torch.empty((B, 2 * max_kept + 1), dtype=torch.float32,
                      device=lf.device)
    with torch.cuda.device(lf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cc_lags_launch(lf.data_ptr(), rf.data_ptr(),
                                 partial.data_ptr(), out.data_ptr(),
                                 B, n, max_kept, stream)
    check_launch(err, "cc_lags")
    LAUNCHES["cc_lags"] += 1
    return out


def cc_kept_lags(lf: torch.Tensor, rf: torch.Tensor,
                 max_kept: int) -> torch.Tensor:
    """corr[l] for l in [-max_kept, max_kept]: (B, n) x2 -> (B, 2K+1) with
    corr[b, s - K] = sum_m rf[b, m] lf[b, m + s - K] (lf zero outside).

    Needs n % 128 == 0 and 0 < max_kept <= 63 (ValueError otherwise), the
    contract of the TPU kernel. CUDA tensors run the CUDA kernel; CPU
    tensors the plain version."""
    _check(lf, rf, max_kept)
    if lf.is_cuda:
        return cc_kept_lags_cuda(lf, rf, max_kept)
    from .xcorr import cc_kept_lags_plain
    return cc_kept_lags_plain(lf, rf, max_kept)
