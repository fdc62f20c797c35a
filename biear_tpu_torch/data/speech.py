"""Source-filter synthetic speech pools: the protocol's speech corpus.

A copy of ``biear_tpu/data/speech.py`` (the port imports nothing of the
JAX package), numpy and scipy only, so that a seed gives the same pool in
both packages bit for bit. Per segment:
  * a SPEAKER profile (F0 register, vocal-tract length factor, speaking
    rate, breathiness); pools built with different seeds share no
    speakers, so an unseen-pool test split is a true new-speakers split;
  * a phone sequence: voiced (glottal pulse train with jitter / shimmer
    -> cascade of 4 formant resonators), unvoiced (noise ->
    fricative-shaped resonances + high-pass) and silence states with
    natural dwell times;
  * F0 declination and micro-contour, formant targets per phone with
    10 ms crossfades, syllabic amplitude modulation.

Segments are peak-normalised float32, at least 1 s at fs, ready for the
``AnechoicSynthesizer`` / ``ReverbSynthesizer`` pools. The pool is built
on the host once; the synthesizer then keeps it on the device.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter


# Vowel-space formant targets (Hz) — ranges, not a phoneme inventory:
# F1/F2 sampled jointly from a plausible articulation box, F3/F4 higher.
_F1_RANGE = (260.0, 820.0)
_F2_MIN_GAP = 250.0
_F2_RANGE = (850.0, 2450.0)
_F3_RANGE = (2250.0, 3100.0)
_F4_RANGE = (3300.0, 4300.0)


def _resonator_coeffs(freq, bw, fs):
    """2nd-order all-pole resonator (digital formant filter)."""
    r = np.exp(-np.pi * bw / fs)
    theta = 2.0 * np.pi * freq / fs
    a = np.array([1.0, -2.0 * r * np.cos(theta), r * r])
    # unity gain at the resonance peak (approx): scale by (1-r) terms
    b = np.array([(1.0 - r) * np.sqrt(1.0 - 2.0 * r * np.cos(2 * theta)
                                      + r * r)])
    return b, a


def speaker_profile(rng):
    """Random speaker: F0 register, vocal-tract scale, rate, voice quality."""
    return {
        "f0_base": float(np.exp(rng.uniform(np.log(85.0), np.log(255.0)))),
        "vtl": float(rng.uniform(0.86, 1.16)),     # formant scale factor
        "rate": float(rng.uniform(3.0, 6.5)),      # phones per second
        "breath": float(rng.uniform(0.02, 0.15)),  # aspiration noise level
        "jitter": float(rng.uniform(0.005, 0.02)),
        "shimmer": float(rng.uniform(0.03, 0.10)),
    }


def _glottal_source(f0_curve, fs, rng, jitter, shimmer):
    """Rosenberg-like glottal flow derivative from an F0 contour."""
    n = len(f0_curve)
    # per-period jitter: perturb instantaneous F0 with lowpassed noise
    pert = rng.standard_normal(n)
    pert = lfilter(*_resonator_coeffs(min(f0_curve.mean(), 400.0) / 2,
                                      60.0, fs), pert)
    pert /= (np.abs(pert).max() + 1e-9)
    phase = np.cumsum(f0_curve * (1.0 + jitter * 3.0 * pert)) / fs
    e = np.mod(phase, 1.0)
    # glottal flow: rising e^2(1.5-e) shape, open quotient ~0.6; the
    # DERIVATIVE is the acoustic excitation
    oq = 0.6
    flow = np.where(e < oq, (e / oq) ** 2 * (1.5 - e / oq), 0.0)
    exc = np.diff(flow, prepend=flow[:1]) * fs / np.maximum(f0_curve, 1.0)
    # shimmer: slow random amplitude modulation
    am = rng.standard_normal(n)
    am = lfilter(*_resonator_coeffs(8.0, 12.0, fs), am)
    am /= (np.abs(am).max() + 1e-9)
    return exc * (1.0 + shimmer * am)


def _one_phone(rng, prof, dur, fs, kind):
    """One phone's waveform (no crossfade margins)."""
    n = max(int(dur * fs), 8)
    if kind == "sil":
        return np.zeros(n)
    if kind == "unvoiced":
        # fricative: noise through 1-2 broad high resonances + tilt
        x = rng.standard_normal(n)
        fc = rng.uniform(1800.0, 6200.0) * prof["vtl"]
        b, a = _resonator_coeffs(min(fc, 0.45 * fs), rng.uniform(400, 1200),
                                 fs)
        x = lfilter(b, a, x)
        x = np.diff(x, prepend=x[:1])            # high-pass tilt
        return x / (np.std(x) + 1e-9) * rng.uniform(0.15, 0.5)
    # voiced: F0 contour with declination + micro-intonation
    t = np.arange(n) / fs
    f0 = prof["f0_base"] * (1.0 + rng.uniform(-0.12, 0.25)) \
        * (1.0 - 0.1 * t / max(t[-1], 1e-3)) \
        * (1.0 + 0.05 * np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * t
                               + rng.uniform(0, 6.2)))
    exc = _glottal_source(f0, fs, rng, prof["jitter"], prof["shimmer"])
    exc = exc + prof["breath"] * rng.standard_normal(n) * np.std(exc)
    # formant cascade, vocal-tract-scaled
    f1 = rng.uniform(*_F1_RANGE)
    f2 = rng.uniform(max(f1 + _F2_MIN_GAP, _F2_RANGE[0]), _F2_RANGE[1])
    f3 = rng.uniform(*_F3_RANGE)
    f4 = rng.uniform(*_F4_RANGE)
    y = exc
    for f, bwlo, bwhi in ((f1, 50, 90), (f2, 60, 110), (f3, 90, 160),
                          (f4, 120, 220)):
        fk = min(f * prof["vtl"], 0.45 * fs)
        b, a = _resonator_coeffs(fk, rng.uniform(bwlo, bwhi), fs)
        y = lfilter(b, a, y)
    return y / (np.std(y) + 1e-9)


_DWELL = {"voiced": (0.06, 0.22), "unvoiced": (0.04, 0.14),
          "sil": (0.05, 0.30)}
_NEXT = {  # simple phone-class transition table
    "voiced": (("voiced", 0.45), ("unvoiced", 0.40), ("sil", 0.15)),
    "unvoiced": (("voiced", 0.75), ("unvoiced", 0.10), ("sil", 0.15)),
    "sil": (("voiced", 0.70), ("unvoiced", 0.30), ("sil", 0.0)),
}


def make_speech_segment(rng, prof, seg_len: int, fs: int):
    """One peak-normalised speech-like segment of exactly seg_len samples."""
    xfade = max(int(0.010 * fs), 4)
    parts = []
    total = 0
    kind = "voiced" if rng.uniform() < 0.8 else "unvoiced"
    rate_scale = 1.0 / prof["rate"] * 4.5     # dwell scale vs speaking rate
    while total < seg_len + xfade:
        lo, hi = _DWELL[kind]
        dur = rng.uniform(lo, hi) * rate_scale
        parts.append((kind, _one_phone(rng, prof, dur, fs, kind)))
        total += len(parts[-1][1]) - xfade
        kinds, probs = zip(*_NEXT[kind])
        kind = kinds[int(rng.choice(len(kinds), p=np.asarray(probs)))]
    # overlap-add with 10 ms crossfades
    out = np.zeros(total + 2 * xfade)
    ramp = 0.5 * (1 - np.cos(np.pi * np.arange(xfade) / xfade))
    pos = 0
    for _, p in parts:
        w = np.ones(len(p))
        w[:xfade] = ramp
        w[-xfade:] = ramp[::-1]
        out[pos:pos + len(p)] += p * w
        pos += len(p) - xfade
    # syllabic energy modulation (3-7 Hz), then crop and normalise
    t = np.arange(seg_len) / fs
    syl = 0.65 + 0.35 * np.sin(2 * np.pi * rng.uniform(2.5, 6.0) * t
                               + rng.uniform(0, 6.2))
    x = out[:seg_len] * syl
    peak = np.abs(x).max()
    if peak < 1e-6:                            # all-silence draw: retry
        return make_speech_segment(rng, prof, seg_len, fs)
    return (x / peak).astype(np.float32)


def make_speech_pool(n_segments: int, seg_len: int = 16000,
                     fs: int = 16000, seed: int = 0,
                     n_speakers: int | None = None):
    """A pool of n_segments speech-like segments from a closed speaker set.

    seed namespaces BOTH the speaker set and the utterances: pools built
    with different seeds share no speakers (the reference's TIMIT
    TRAIN/TEST separation, generate_anechoic_data.py:22-27).
    """
    rng = np.random.default_rng(seed)
    if n_speakers is None:
        n_speakers = max(n_segments // 10, 8)
    profiles = [speaker_profile(rng) for _ in range(n_speakers)]
    segs = np.empty((n_segments, seg_len), np.float32)
    for i in range(n_segments):
        prof = profiles[int(rng.integers(0, n_speakers))]
        segs[i] = make_speech_segment(rng, prof, seg_len, fs)
    return segs
