"""Waveform framing for the frontends.

Counterpart of ``biear_tpu/ops/framing.py``: all T frames of a ~1 s
waveform at once, so the window and the transform batch over (B, T).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def hann_window_periodic(win: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window's default), float32 numpy."""
    n = np.arange(win)
    return np.asarray(0.5 * (1.0 - np.cos(2.0 * np.pi * n / win)),
                      dtype=np.float32)


def frame_params(fs: int, timesteps: int, hop_ratio: float = 1.0):
    """win = round(fs / timesteps), hop = max(1, round(win * hop_ratio))."""
    win = int(round(fs / timesteps))
    hop = max(1, int(round(win * hop_ratio)))
    return win, hop


def frame_1s(wav: torch.Tensor, fs: int, timesteps: int, win: int,
             hop: int) -> torch.Tensor:
    """Frame (B, Nsamp) into exactly `timesteps` frames (B, T, win).

    Pad or crop to `fs` samples, pad up to `win` if fs < win, cut frames of
    `win` every `hop` samples, then crop or zero-pad the frame axis to T."""
    nsamp = wav.shape[1]
    target = fs
    if nsamp < target:
        wav = F.pad(wav, (0, target - nsamp))
    else:
        wav = wav[:, :target]
    if target < win:
        wav = F.pad(wav, (0, win - target))
        target = win
    n_avail = (target - win) // hop + 1
    n_take = min(n_avail, timesteps)
    frames = wav.unfold(1, win, hop)[:, :n_take]
    if n_take < timesteps:
        frames = F.pad(frames, (0, 0, 0, timesteps - n_take))
    return frames
