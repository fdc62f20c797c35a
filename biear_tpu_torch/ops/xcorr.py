"""Binaural cross-correlation feature (the x3 input).

Counterpart of ``biear_tpu/ops/xcorr.py``: the mean-removed ears are
correlated over the +/-3 ms lag window, peak-normalised and linearly
resampled to ``num_lags`` points, exactly like ``np.interp`` on the
reference's cropped ``np.correlate`` output.

  * n % 128 == 0 and max_kept <= 63 (16 kHz, 1 s: 97 lags): the kept lags
    come from ``ops.window_gather.cc_kept_lags`` (the CUDA kernel on the
    card, ``cc_kept_lags_plain`` on the CPU).
  * n % 128 == 0 and max_kept == 64: the plain block product.
  * any other n: an rFFT correlation with fft_len >= n + max_kept.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import constant_cache, precision_highest


@functools.lru_cache(maxsize=None)
def lag_plan(n: int, fs: int, num_lags: int, max_lag_ms: float):
    """Static crop + interp plan, computed in float64 like ``np.interp``.

    lags = arange(-n+1, n)/fs, masked to the +/- max_lag window, then
    resampled onto linspace(-mls, mls, num_lags). Returns (kept integer
    lags, interp left index, interp weights) as numpy arrays."""
    lags = np.arange(-n + 1, n, dtype=np.int64) / float(fs)
    mls = max_lag_ms * 1e-3
    mask = np.logical_and(lags >= -mls, lags <= mls)
    kept = np.nonzero(mask)[0] - (n - 1)
    lags_crop = lags[mask]
    target = np.linspace(-mls, mls, num_lags)
    j = np.searchsorted(lags_crop, target, side="left")
    j = np.clip(j, 1, len(lags_crop) - 1)
    x0, x1 = lags_crop[j - 1], lags_crop[j]
    w = np.clip((target - x0) / (x1 - x0), 0.0, 1.0)
    return kept.astype(np.int64), (j - 1).astype(np.int64), w.astype(np.float32)


@constant_cache
def device_lag_plan(n: int, fs: int, num_lags: int, max_lag_ms: float,
                    device: torch.device) -> tuple:
    """lag_plan's interp index j0 and weights w, and the rFFT path's
    column of each kept lag (``kept mod fft_len``, None on the lag
    kernel's path), as tensors on `device`, copied once per geometry and
    device (not on every call)."""
    kept, j0, w = lag_plan(n, fs, num_lags, max_lag_ms)
    fft_len = rfft_len(n, int(np.max(np.abs(kept))))
    idx = (None if fft_len is None
           else torch.as_tensor(np.mod(kept, fft_len), device=device))
    return (torch.as_tensor(j0, device=device),
            torch.as_tensor(w, device=device), idx)


def rfft_len(n: int, max_kept: int) -> int | None:
    """The rFFT correlation's length (a circular wrap at a kept lag l
    aliases corr(l - fft_len), which has zero overlap once fft_len >= n +
    max|kept|), or None where the lag kernel's block path takes n."""
    if n % 128 == 0 and 2 * max_kept <= 128:
        return None
    fft_len = 1
    while fft_len < n + max_kept:
        fft_len *= 2
    return fft_len


def interp_to_lags(cc_crop: torch.Tensor, j0: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Peak-normalise the kept lags, then resample them (np.interp)."""
    peak = cc_crop.abs().amax(dim=-1, keepdim=True) + 1e-8
    cc_crop = cc_crop / peak
    c0 = cc_crop[:, j0]
    c1 = cc_crop[:, j0 + 1]
    return (c0 + w[None, :] * (c1 - c0)).float()


def cc_kept_lags_plain(lf: torch.Tensor, rf: torch.Tensor,
                       max_kept: int) -> torch.Tensor:
    """Plain version of the CUDA lag kernel: corr[l], l in [-K, K].

    One batched block product and a strided-diagonal sum (the JAX
    ``_cc_kept_lags_mxu``). With Lp = pad(lf, K) and m = 128 f + i,
    corr[s - K] = sum_{f,i} rf[128 f + i] Lp[128 f + i + s], so
    C[b, i, j] = sum_f Rf[b, f, i] Lw[b, f, j] (Lw = two-block halo frames
    of Lp) holds every kept lag on the diagonals j = i + s, read at flat
    stride 257 after a pad. Needs n % 128 == 0 and 2K <= 128. The product
    is pinned to full f32 (TF32 off on the card)."""
    B, n = lf.shape
    nf = n // 128
    halo = 2 * 128
    Lp = F.pad(lf, (max_kept, 128 - max_kept))
    Lb = Lp.reshape(B, nf + 1, 128)
    Lw = torch.cat([Lb[:, :nf], Lb[:, 1:nf + 1]], dim=-1)
    Rf = rf.reshape(B, nf, 128)
    with precision_highest():
        C = torch.einsum("bfi,bfj->bij", Rf, Lw)              # (B, 128, 256)
    n_s = 2 * max_kept + 1
    Cp = F.pad(C.reshape(B, 128 * halo), (0, 128))
    return Cp.reshape(B, 128, halo + 1)[:, :, :n_s].sum(dim=1)


def cross_correlation_feature(left: torch.Tensor, right: torch.Tensor,
                              fs: int, num_lags: int = 100,
                              max_lag_ms: float = 3.0) -> torch.Tensor:
    """Batched CC feature: left, right (B, n) -> (B, num_lags) float32.

    corr[l] = sum_m left[m + l] right[m] after mean removal, matching
    np.correlate(left, right, "full") at the kept lags."""
    if left.ndim == 1:
        return cross_correlation_feature(left[None], right[None], fs,
                                         num_lags, max_lag_ms)[0]
    from .window_gather import MAX_KEPT, cc_kept_lags

    n = left.shape[1]
    kept = lag_plan(n, fs, num_lags, max_lag_ms)[0]
    max_kept = int(np.max(np.abs(kept)))
    j0, w, idx = device_lag_plan(n, fs, num_lags, max_lag_ms, left.device)
    lf = left - left.mean(dim=-1, keepdim=True)
    rf = right - right.mean(dim=-1, keepdim=True)

    fft_len = rfft_len(n, max_kept)
    if fft_len is None:
        if max_kept <= MAX_KEPT:
            cc = cc_kept_lags(lf, rf, max_kept)
        else:
            cc = cc_kept_lags_plain(lf, rf, max_kept)
        return interp_to_lags(cc, j0, w)

    L = torch.fft.rfft(lf, n=fft_len)
    R = torch.fft.rfft(rf, n=fft_len)
    corr = torch.fft.irfft(L * torch.conj(R), n=fft_len)
    return interp_to_lags(corr[:, idx], j0, w)
