"""ERB centre frequencies, baseline Q and the deltaQ profile.

Counterpart of ``biear_tpu/ops/erb.py``. These are static model constants:
built in numpy float64 like the reference and cast to float32 once.
"""

from __future__ import annotations

import numpy as np


def erb_spaced_fc_and_q(N: int = 100, fmin: float = 50.0,
                        fmax: float = 7200.0, erb_factor: float = 1.019):
    """N centre frequencies equally spaced on the ERB-rate axis, and
    Q0 = fc / (erb_factor * ERB(fc)). Returns (fc, Q0), (N,) float32."""
    Emin = 21.4 * np.log10(4.37 * fmin / 1000.0 + 1.0)
    Emax = 21.4 * np.log10(4.37 * fmax / 1000.0 + 1.0)
    E = np.linspace(Emin, Emax, N)
    fc = (10.0 ** (E / 21.4) - 1.0) * 1000.0 / 4.37
    bw = erb_factor * (24.7 * (4.37 * fc / 1000.0 + 1.0))
    Q0 = fc / bw
    return fc.astype(np.float32), Q0.astype(np.float32)


def make_deltaQ_profile(fc_hz, deltaQ_base: float = 2.0,
                        low_factor: float = 0.5, high_factor: float = 1.0):
    """Per-band maximum |deltaQ|: low_factor -> high_factor linearly along
    the normalised ERB-rate of fc, times deltaQ_base, floored at 1e-3.
    Computed in numpy float32, like the reference."""
    fc_np = np.asarray(fc_hz, dtype=np.float32)
    E = 21.4 * np.log10(4.37 * fc_np / 1000.0 + 1.0)
    E = (E - E.min()) / (E.max() - E.min() + 1e-12)
    mult = low_factor + (high_factor - low_factor) * E
    return np.clip(deltaQ_base * mult, 1e-3, None).astype(np.float32)
