"""Passive-feature synthesis: the passive family trains on features made
from freshly synthesised waveforms, with no offline feature stage.

Counterpart of ``biear_tpu/data/passive_synth.py::PassiveFeatureSynth``.
It wraps any waveform synthesizer of the port (``AnechoicSynthesizer``,
``ReverbSynthesizer``) and re-emits each (wavL, wavR, x3, y) batch as the
passive 6-tuple (x1 magL, x2 magR, x3 CC, x4 phaseL, x5 phaseR, y), the
layout ``train.loop.passive_loss`` and ``PassiveBiEAR`` consume. The
features (``ops.features.passive_features``) run on the synthesizer's
device.
"""

from __future__ import annotations

import functools

import torch

from ..ops.features import passive_features


class PassiveFeatureSynth:
    """Adapter: waveform synthesizer -> passive 5-feature batches."""

    def __init__(self, inner, data_dim: int = 100, timesteps: int = 19):
        self.inner = inner
        self.data_dim = int(data_dim)
        self.timesteps = int(timesteps)
        self.fs = inner.fs
        self.device = inner.device
        self.num_lags = getattr(inner, "num_lags", 100)
        # per-row element count for SynthEvalDataset's memory estimate:
        # 4 x (T, D) feature planes + CC + the 56-wide label row
        self.row_elems = (4 * self.timesteps * self.data_dim
                          + self.num_lags + 56)

    @property
    def bank(self):
        return self.inner.bank

    def _features(self, wav: torch.Tensor):
        return passive_features(wav, self.fs, self.data_dim, self.timesteps)

    def to_passive(self, batch):
        """(wavL, wavR, x3, y, ...) -> (x1, x2, x3, x4, x5, y, ...)."""
        wavL, wavR, x3, y = batch[:4]
        x1, x4 = self._features(wavL)
        x2, x5 = self._features(wavR)
        return (x1, x2, x3, x4, x5, y) + tuple(batch[4:])

    def sample_batch(self, gen: torch.Generator, batch_size: int,
                     n_src: int | None = None, rows=None):
        """The inner synthesizer's batch (`rows` of it) as features."""
        with torch.no_grad():
            return self.to_passive(self.inner.sample_batch(
                gen, batch_size, n_src=n_src, rows=rows))

    def batch_fn(self, batch_size: int, n_src: int | None = None,
                 rows=None):
        """gen -> passive batch closure for the fused train chunk: the same
        draws as sample_batch for the same generator state."""
        return functools.partial(self.sample_batch, batch_size=batch_size,
                                 n_src=n_src, rows=rows)
