"""Inputs made from the run's seed: the HRIR and BRIR banks, the speech
pool and the model's weights.

The bank and pool generators are generalised copies of the port's test
fixtures (``biear_tpu_torch/data/synth.py::make_test_hrir_bank`` and
``make_test_segments``, ``data/synth_reverb.py::make_test_brir_bank``);
the benchmark imports none of them. Every
generator takes its own stream of the seed (``sub_seed``), so adding an
input never changes another's draws.
"""

from __future__ import annotations

import numpy as np
import torch

SPEED_OF_SOUND = 343.0


def sub_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the input `name` of run `seed` (any integer)."""
    words = [int(seed) % 2 ** 64 & 0xFFFFFFFF, (int(seed) % 2 ** 64) >> 32,
             *name.encode()]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, name))


def device_gen(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, name))


def hrir_bank(seed: int, azimuths: int, distances, taps: int,
              fs: int = 16000):
    """(ir (M, 2, taps) float32, az (M,), dist (M,)): `azimuths` equally
    spaced azimuths (degrees from 0) at each distance, M = azimuths x
    distances. Each ear: a propagation delay (distance / c) plus the
    interaural delay (up to 0.7 ms, sine of the azimuth), a level
    difference (+-0.4 sin az, falling as 1 / distance), a 24-tap
    decaying direct response with random amplitudes, and a weak random
    decaying tail over every tap."""
    r = rng(seed, "hrir")
    az = np.repeat(np.arange(azimuths) * (360.0 / azimuths), len(distances))
    dist = np.tile(np.asarray(distances, np.float64), azimuths)
    M = len(az)
    th = np.deg2rad(az)
    itd = 0.0007 * np.sin(th)
    base = 8 + np.round(dist * fs / SPEED_OF_SOUND).astype(int)
    delays = np.stack([base + np.maximum(0, np.round(-itd * fs)).astype(int),
                       base + np.maximum(0, np.round(itd * fs)).astype(int)],
                      1)                                        # (M, 2)
    gains = np.stack([1.0 + 0.4 * np.sin(th), 1.0 - 0.4 * np.sin(th)], 1)
    gains = gains / dist[:, None] ** 0.5
    k = np.arange(taps)
    rel = k[None, None] - delays[..., None]                     # (M, 2, taps)
    direct = np.where((rel >= 0) & (rel < 24), np.exp(-np.clip(rel, 0, 24)
                                                       / 4.0), 0.0)
    amp = r.uniform(0.7, 1.0, (M, 2, taps))
    tail = 0.02 * r.standard_normal((M, 2, taps)) * np.exp(
        -np.clip(rel, 0, None) / 48.0) * (rel >= 0)
    ir = gains[..., None] * (direct * amp + tail)
    return ir.astype(np.float32), az, dist


def speech_pool(seed: int, n: int, length: int, fs: int = 16000,
                name: str = "speech"):
    """(n, length) float32 speech-like segments: noise under a 2-6 Hz
    syllabic envelope, peak-normalised."""
    r = rng(seed, name)
    t = np.arange(length) / float(fs)
    rate = r.uniform(2, 6, (n, 1))
    phase = r.uniform(0, 6, (n, 1))
    env = 0.5 * (1 + np.sin(2 * np.pi * rate * t[None] + phase))
    x = env * r.standard_normal((n, length))
    return (x / (np.abs(x).max(1, keepdims=True) + 1e-8)).astype(np.float32)


def brir_bank(seed: int, speaker_xy, n_yaw: int, taps: int, fs: int = 16000):
    """(ir (n_yaw, 2, E, taps) float32, yaw (n_yaw,), speaker_xy): head
    yaws over -90..90 degrees; per (yaw, speaker) a direct path with the
    relative azimuth's ITD and ILD, attenuated by 1 + distance, and a
    diffuse tail (80 ms decay) from 40 samples after it."""
    r = rng(seed, "brir")
    xy = np.asarray(speaker_xy, np.float64)
    E = len(xy)
    yaw = np.linspace(-90.0, 90.0, n_yaw) % 360.0
    az = np.degrees(np.arctan2(xy[:, 1], xy[:, 0])) % 360.0
    d = np.sqrt((xy ** 2).sum(1))
    rel = np.deg2rad((az[None] - yaw[:, None]) % 360.0)        # (Y, E)
    itd = 0.0007 * np.sin(rel)
    base = 10 + (d * fs / SPEED_OF_SOUND).astype(int) % 40     # (E,)
    dl = base[None] + np.maximum(0, np.round(-itd * fs)).astype(int)
    dr = base[None] + np.maximum(0, np.round(itd * fs)).astype(int)
    k = np.arange(taps)
    ir = np.zeros((n_yaw, 2, E, taps))
    for ear, dly, g in ((0, dl, 1.0 + 0.4 * np.sin(rel)),
                        (1, dr, 1.0 - 0.4 * np.sin(rel))):
        rk = k[None, None] - dly[..., None]
        ir[:, ear] = (g / (1.0 + d[None]))[..., None] * np.where(
            (rk >= 0) & (rk < 16), np.exp(-np.clip(rk, 0, 16) / 3.0), 0.0)
    start = (base + 40)[None, None, :, None]
    rk = k[None, None, None] - start
    tail = r.standard_normal((n_yaw, 2, E, taps)) * np.exp(
        -np.clip(rk, 0, None) / (0.08 * fs)) * (rk >= 0)
    ir += 0.05 * tail / (1.0 + d)[None, None, :, None]
    return ir.astype(np.float32), yaw, xy
