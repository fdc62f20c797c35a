"""The passive family's offline features: magnitude dB and phase per band.

Counterpart of ``biear_tpu/ops/features.py::passive_features``. These
features use their own filter family, a Gaussian-envelope filterbank on
the STFT bins with bw = 1.5 * ERB(fc) and fmax = fs / 2
(``build_gammatone_filterbank``); the in-model filterbank
(``ops/filterbank.py``, 1.019 * ERB, 0.9 * fs / 2) is a different one and
the two are kept apart.

A waveform (B, n) is cut into t = 1 + (n - n_fft) // hop frames of n_fft
samples (``unfold``, the same frames as JAX's index gather), windowed by a
periodic Hann of ``win`` samples centre-padded to n_fft, transformed with
``rfft`` and weighted with H in full f32 products (TF32 off). The result
is padded (magnitude -80 dB, phase a copy of the last frame) or cropped to
``timesteps`` frames. At 16 kHz and 19 frames hop = win = 842 and n_fft =
1024, so t = 18 and frame 18 is always padding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import no_tf32

DATA_DIM = 100
TIMESTEPS = 19
FMIN = 50.0            # the filterbank's lowest centre; its highest is fs / 2
MAG_FLOOR = 1e-12      # magnitudes are clamped here before the dB


def build_gammatone_filterbank(fs, n_fft, n_band=DATA_DIM, fmin=FMIN,
                               fmax=None):
    """Gaussian-envelope filterbank on the rFFT bins, bw = 1.5 * ERB,
    rows normalised to sum 1: (n_band, n_fft // 2 + 1) float32."""
    if fmax is None:
        fmax = fs / 2.0
    freqs = np.linspace(0, fs / 2.0, n_fft // 2 + 1)
    e = lambda f: 21.4 * np.log10(4.37e-3 * f + 1.0)
    einv = lambda x: (10 ** (x / 21.4) - 1.0) / 4.37e-3
    centers = einv(np.linspace(e(fmin), e(fmax), n_band))
    H = np.zeros((n_band, freqs.size), dtype=np.float32)
    for i, fc in enumerate(centers):
        erb = 24.7 * (4.37e-3 * fc + 1.0)
        bw = 1.5 * erb
        H[i, :] = np.exp(-0.5 * ((freqs - fc) / bw) ** 2)
    H /= (H.sum(axis=1, keepdims=True) + 1e-8)
    return H


def _stft_params(n: int, timesteps: int):
    """hop = n // timesteps, win = hop, n_fft = the next power of two >=
    win."""
    hop = max(1, n // timesteps)
    win = hop
    n_fft = 1
    while n_fft < win:
        n_fft *= 2
    return n_fft, hop, win


def _padded_hann(win_length: int, n_fft: int):
    """Periodic Hann of win_length, centre-padded to n_fft."""
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / win_length))
    pad = n_fft - win_length
    lpad = pad // 2
    return np.pad(w, (lpad, pad - lpad)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def passive_consts(fs: int, n: int, timesteps: int, data_dim: int):
    """(n_fft, hop, t frames, window (n_fft,), H (data_dim, F)), numpy."""
    n_fft, hop, win = _stft_params(n, timesteps)
    H = build_gammatone_filterbank(fs, n_fft, data_dim)
    t = 1 + (n - n_fft) // hop if n >= n_fft else 0
    return n_fft, hop, t, _padded_hann(win, n_fft), H


@functools.lru_cache(maxsize=None)
def _device_consts(fs: int, n: int, timesteps: int, data_dim: int,
                   device: torch.device):
    """The window and H.T as tensors on `device`, built once per geometry
    and device (a pageable host copy per call would cost a transfer)."""
    n_fft, hop, t, w, H = passive_consts(fs, n, timesteps, data_dim)
    return (n_fft, hop, t, torch.as_tensor(w, device=device),
            torch.as_tensor(np.ascontiguousarray(H.T), device=device))


def passive_features(wav: torch.Tensor, fs: int = 16000,
                     data_dim: int = DATA_DIM, timesteps: int = TIMESTEPS):
    """wav (B, n) -> (mag dB (B, T, D), phase (B, T, D)) on wav's device."""
    wav = wav.float()
    n = wav.shape[1]
    n_fft, hop, t, w, Ht = _device_consts(int(fs), int(n), int(timesteps),
                                          int(data_dim), wav.device)
    if t < 1:
        raise ValueError(f"waveforms of {n} samples hold no {n_fft}-sample "
                         "frame")
    frames = wav.unfold(-1, n_fft, hop)[:, :t] * w          # (B, t, n_fft)
    S = torch.fft.rfft(frames, n=n_fft)                     # (B, t, F)
    with no_tf32():
        bc_re = S.real @ Ht
        bc_im = S.imag @ Ht
    mag = torch.sqrt(bc_re ** 2 + bc_im ** 2)
    mag_db = 20.0 * torch.log10(torch.clamp(mag, min=MAG_FLOOR))
    phase = torch.atan2(bc_im, bc_re)
    if t < timesteps:
        pad = timesteps - t
        mag_db = torch.cat([mag_db, mag_db.new_full(
            (mag_db.shape[0], pad, mag_db.shape[2]), -80.0)], dim=1)
        phase = torch.cat([phase, phase[:, -1:].expand(-1, pad, -1)], dim=1)
    else:
        mag_db = mag_db[:, :timesteps]
        phase = phase[:, :timesteps]
    return mag_db, phase
