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

Below it, the offline feature library of the reference's ``utils.py``
API, per utterance in numpy and scipy: copies of
``biear_tpu/ops/features.py``'s STFT (librosa's ``center=False``), the
complex band-integration and power features, and Slaney's ERB gammatone
filterbank with its ``gtgram`` and the time-domain IIR + Hilbert route.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import constant_cache, precision_highest

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


@constant_cache
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
    with precision_highest():
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


# ---------------- the offline library, numpy (utils.py's API) ----------------

def stft_center_false(wav, n_fft: int, hop: int, win_length: int):
    """librosa.stft(..., center=False) in numpy: frames of n_fft samples
    from k * hop, windowed by the centre-padded Hann -> (n_freq, T)
    complex64."""
    wav = np.asarray(wav, np.float32)
    n = len(wav)
    t = 1 + (n - n_fft) // hop if n >= n_fft else 0
    w = _padded_hann(win_length, n_fft)
    frames = np.stack([wav[k * hop:k * hop + n_fft] for k in range(t)])
    return np.fft.rfft(frames * w, n=n_fft).T.astype(np.complex64)


def _pad_T(mag_db, phase, timesteps):
    T = mag_db.shape[1]
    if T < timesteps:
        pad = timesteps - T
        mag_db = np.pad(mag_db, ((0, 0), (0, pad)), constant_values=-80.0)
        phase = np.pad(phase, ((0, 0), (0, pad)), mode="edge")
    else:
        mag_db = mag_db[:, :timesteps]
        phase = phase[:, :timesteps]
    return mag_db, phase


def _band_complex(wav_1d, fs, data_dim, timesteps, fmin, fmax):
    n_fft, hop, win = _stft_params(len(wav_1d), timesteps)
    S = stft_center_false(wav_1d, n_fft, hop, win)
    return build_gammatone_filterbank(fs, n_fft, data_dim, fmin, fmax), S


def stft_gammatone_mag_phase(wav_1d, fs, data_dim=DATA_DIM,
                             timesteps=TIMESTEPS, fmin=FMIN, fmax=None):
    """(T, D) magnitude dB and phase by complex band integration H @ S
    (magnitude floor 1e-12)."""
    H, S = _band_complex(wav_1d, fs, data_dim, timesteps, fmin, fmax)
    bc = H @ S
    mag_db = 20.0 * np.log10(np.maximum(np.abs(bc), 1e-12))
    mag_db, phase = _pad_T(mag_db, np.angle(bc), timesteps)
    return mag_db.T.astype(np.float32), phase.T.astype(np.float32)


def compute_gammatone_mag_phase(wav_1d, fs, data_dim=DATA_DIM,
                                timesteps=TIMESTEPS, fmin=FMIN, fmax=None):
    """The same pipeline with the 1e-10 magnitude floor."""
    H, S = _band_complex(wav_1d, fs, data_dim, timesteps, fmin, fmax)
    bc = H @ S
    mag_db = 20.0 * np.log10(np.maximum(np.abs(bc), 1e-10))
    mag_db, phase = _pad_T(mag_db, np.angle(bc), timesteps)
    return mag_db.T.astype(np.float32), phase.T.astype(np.float32)


def compute_gammatone_feature_stft(wav_1d, fs, data_dim=DATA_DIM,
                                   timesteps=TIMESTEPS, fmin=FMIN, fmax=None):
    """(T, D) power-spectrum band energies in dB, H @ |S|^2."""
    H, S = _band_complex(wav_1d, fs, data_dim, timesteps, fmin, fmax)
    band = np.maximum(H @ (np.abs(S) ** 2), 1e-12)
    db = 10.0 * np.log10(band)
    T = db.shape[1]
    if T < timesteps:
        db = np.pad(db, ((0, 0), (0, timesteps - T)), constant_values=-80.0)
    else:
        db = db[:, :timesteps]
    return db.T.astype(np.float32)


# Slaney's "An Efficient Implementation of the Patterson-Holdsworth
# Auditory Filter Bank" (Apple TR #35): ERBSpace, MakeERBFilters,
# ERBFilterBank, the algorithm of the `gammatone` package's gtgram that the
# reference calls.
_EARQ, _MINBW = 9.26449, 24.7


def erb_space_slaney(low_freq: float, high_freq: float, num: int):
    """ERB-rate spaced centre frequencies, descending from high_freq to
    low_freq (ERBSpace.m)."""
    c = _EARQ * _MINBW
    return -c + np.exp(np.arange(1, num + 1) *
                       (-np.log(high_freq + c) + np.log(low_freq + c))
                       / num) * (high_freq + c)


def make_erb_filters(fs: float, centre_freqs, width: float = 1.0):
    """MakeERBFilters.m's coefficients, one row per filter:
    [A0 A11 A12 A13 A14 A2 B0 B1 B2 gain] (float64)."""
    T = 1.0 / fs
    cf = np.asarray(centre_freqs, np.float64)
    erb = width * ((cf / _EARQ) + _MINBW)
    B = 1.019 * 2.0 * np.pi * erb

    arg = 2.0 * cf * np.pi * T
    vec = np.exp(2j * arg)

    A0 = T
    A2 = 0.0
    B0 = 1.0
    B1 = -2.0 * np.cos(arg) / np.exp(B * T)
    B2 = np.exp(-2.0 * B * T)

    rt_pos = np.sqrt(3.0 + 2.0 ** 1.5)
    rt_neg = np.sqrt(3.0 - 2.0 ** 1.5)
    common = -T * np.exp(-(B * T))

    k11 = np.cos(arg) + rt_pos * np.sin(arg)
    k12 = np.cos(arg) - rt_pos * np.sin(arg)
    k13 = np.cos(arg) + rt_neg * np.sin(arg)
    k14 = np.cos(arg) - rt_neg * np.sin(arg)
    A11, A12, A13, A14 = (common * k for k in (k11, k12, k13, k14))

    gain_arg = np.exp(1j * arg - B * T)
    gain = np.abs(
        (vec - gain_arg * k11) * (vec - gain_arg * k12)
        * (vec - gain_arg * k13) * (vec - gain_arg * k14)
        * (T * np.exp(B * T)
           / (-1.0 / np.exp(B * T) + 1.0 + vec * (1.0 - np.exp(B * T))))
        ** 4)

    fcoefs = np.zeros((len(cf), 10), np.float64)
    for i, col in enumerate((A0, A11, A12, A13, A14, A2, B0, B1, B2, gain)):
        fcoefs[:, i] = col
    return fcoefs


def erb_filterbank_slaney(wave, fcoefs):
    """ERBFilterBank.m: four cascaded 2nd-order sections per channel,
    wave (N,) -> (n_filters, N) float64."""
    from scipy.signal import lfilter

    wave = np.asarray(wave, np.float64)
    out = np.zeros((fcoefs.shape[0], wave.shape[0]), np.float64)
    for i, (A0, A11, A12, A13, A14, A2, B0, B1, B2, g) in enumerate(fcoefs):
        Bs = [B0, B1, B2]
        y = lfilter([A0 / g, A11 / g, A2 / g], Bs, wave)
        y = lfilter([A0, A12, A2], Bs, y)
        y = lfilter([A0, A13, A2], Bs, y)
        y = lfilter([A0, A14, A2], Bs, y)
        out[i] = y
    return out


def gtgram_slaney(wave, fs, window_time, hop_time, channels, f_min):
    """The `gammatone` package's gtgram: the Slaney filterbank -> power ->
    root mean over hop-strided windows, (channels, n_windows) float64."""
    cfs = erb_space_slaney(f_min, fs / 2.0, channels)
    bm = erb_filterbank_slaney(wave, make_erb_filters(fs, cfs))
    xe = bm ** 2
    nwin = int(round(window_time * fs))
    hop = int(round(hop_time * fs))
    cols = max(1 + int(np.floor((xe.shape[1] - nwin) / hop)), 0)
    y = np.zeros((channels, cols))
    for c in range(cols):
        y[:, c] = np.sqrt(xe[:, c * hop:c * hop + nwin].mean(axis=1))
    return y


def compute_gammatone_feature(wav_1d, fs, data_dim=DATA_DIM,
                              timesteps=TIMESTEPS, fmin: float = FMIN):
    """(timesteps, data_dim) gtgram band energies: window = hop =
    1 / timesteps s, 20 log10(gt + 1e-8), then padded with 0.0 (after the
    dB, the reference's quirk) or cut to `timesteps` frames."""
    wav = np.asarray(wav_1d, np.float32)
    win_time = 1.0 / timesteps
    gt = gtgram_slaney(wav, fs, win_time, win_time, data_dim, fmin)
    gt = 20.0 * np.log10(gt + 1e-8)
    if gt.shape[1] < timesteps:
        gt = np.pad(gt, ((0, 0), (0, timesteps - gt.shape[1])),
                    mode="constant")
    elif gt.shape[1] > timesteps:
        gt = gt[:, :timesteps]
    return gt.T.astype(np.float32)


def compute_gammatone_mag_phase_direct(wav_1d, fs, data_dim=DATA_DIM,
                                       timesteps=TIMESTEPS, fmin=FMIN,
                                       fmax=None, order=4):
    """The time-domain route: scipy's IIR gammatone per band and the
    Hilbert envelope -> per-frame RMS dB and a frame phase, (T, D) each.

    The reference's phase index is kept: it indexes the frame's slice with
    the absolute index start + frame_len // 2, clamped to the slice's end,
    so frame 0 samples its centre and every later frame its last point."""
    from scipy.signal import gammatone, hilbert, lfilter

    if fmax is None:
        fmax = fs / 2.0
    wav = np.asarray(wav_1d, np.float32)
    e = lambda f: 21.4 * np.log10(4.37e-3 * f + 1.0)
    einv = lambda x: (10 ** (x / 21.4) - 1.0) / 4.37e-3
    centers = np.clip(einv(np.linspace(e(fmin), e(fmax), data_dim)),
                      1.0, fs / 2 - 1.0)
    n = len(wav)
    frame_len = max(1, n // timesteps)
    total = frame_len * timesteps
    wav = (np.pad(wav, (0, total - n)) if total > n else wav[:total])

    band_db = np.zeros((data_dim, timesteps), np.float32)
    band_ph = np.zeros((data_dim, timesteps), np.float32)
    for b, fc in enumerate(centers):
        bc, ac = gammatone(fc, "iir", fs=fs)
        analytic = hilbert(lfilter(bc, ac, wav))
        mag = np.maximum(np.abs(analytic), 1e-12)
        ph = np.angle(analytic)
        for t in range(timesteps):
            s = t * frame_len
            rms = np.sqrt(np.mean(mag[s:s + frame_len] ** 2))
            band_db[b, t] = 20.0 * np.log10(rms + 1e-12)
            ci = min(s + frame_len // 2, frame_len - 1)
            band_ph[b, t] = ph[s + ci]
    return band_db.T, band_ph.T
