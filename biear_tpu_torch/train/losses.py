"""Input sanitisation shared by training and serving.

Counterpart of ``sanitize_wav`` and ``sanitize_x3`` in
``biear_tpu/train/losses.py``; the losses come with the training slice.
"""

from __future__ import annotations

import torch


def sanitize_x3(x3: torch.Tensor) -> torch.Tensor:
    """nan -> 0, per-sample peak-normalise (floor 1), clamp +-5."""
    x3 = torch.nan_to_num(x3.float(), nan=0.0, posinf=0.0, neginf=0.0)
    scale = torch.clamp(x3.abs().amax(dim=1, keepdim=True), min=1.0)
    return torch.clamp(x3 / scale, -5.0, 5.0)


def sanitize_wav(wavL: torch.Tensor, wavR: torch.Tensor):
    """int16 heuristic, then clamp +-1: if the largest |sample| of the
    WHOLE batch (both ears) exceeds 2, every sample is divided by 32768.
    Decided on the device, without a host sync."""
    wavL, wavR = wavL.float(), wavR.float()
    maxabs = torch.maximum(wavL.abs().amax(), wavR.abs().amax())
    scale = torch.where(maxabs > 2.0, 1.0 / 32768.0, 1.0)
    return (torch.clamp(wavL * scale, -1.0, 1.0),
            torch.clamp(wavR * scale, -1.0, 1.0))
