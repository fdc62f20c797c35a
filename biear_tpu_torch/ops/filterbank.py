"""Gaussian filterbank, forward only.

Counterpart of the forward of ``biear_tpu/ops/filterbank.py``: per frame
and ear, a (B, N, F) Gaussian G is built from the current Q and contracted
against the stacked rhs [mag, re, im, 1] (B, 4, F). The ones row carries
sum_f G, so the row normalisation happens after the contraction
(divide-after form): Y = sum_f G |X| / den, Z = sum_f G X / den.

The JAX filterbank is plain XLA, not a Pallas kernel, so this stays plain
PyTorch. Its hand backward comes with the training slice.

Precision policies:
  * f32: the exact association exp(-0.5 ((f - fc) / bw)^2), f32 product.
    Run it with TF32 off on the card.
  * bf16: the divide-free build exp(D / bw^2), D = -0.5 (f - fc)^2; both
    operands are rounded to bf16 and contracted in f32, which is what
    JAX's bf16 operands with an f32 result compute (a bf16 torch matmul
    would round the result too).
"""

from __future__ import annotations

import torch

EPS_Q = 1e-8
EPS_BW = 1e-8
EPS_NORM = 1e-8


def fb_gauss(Q: torch.Tensor, fc: torch.Tensor,
             f_fft: torch.Tensor) -> torch.Tensor:
    """Unnormalised Gaussian G (B, N, F), reference association (f32)."""
    bw = (fc / (Q + EPS_Q))[..., None] + EPS_BW              # (B, N, 1)
    z = (f_fft[None, :] - fc[:, None]) / bw                  # (B, N, F)
    return torch.exp(-0.5 * z * z)


def fb_gauss_fast(Q: torch.Tensor, fc: torch.Tensor,
                  f_fft: torch.Tensor) -> torch.Tensor:
    """Divide-free G = exp(D * s), D = -0.5 (f - fc)^2, s = 1 / bw^2 (bf16)."""
    bw = (fc / (Q + EPS_Q))[..., None] + EPS_BW
    D = -0.5 * torch.square(f_fft[None, :] - fc[:, None])    # (N, F)
    s = 1.0 / torch.square(bw)
    return torch.exp(D * s)


def stack_rhs(Xmag: torch.Tensor, Xre: torch.Tensor, Xim: torch.Tensor,
              bf16: bool = False) -> torch.Tensor:
    """Contraction rhs (..., 4, F) = [mag, re, im, 1], in bf16 under the
    bf16 policy."""
    rhs = torch.stack([Xmag, Xre, Xim, torch.ones_like(Xmag)], dim=-2)
    return rhs.to(torch.bfloat16) if bf16 else rhs


def fb_forward(Q: torch.Tensor, fc: torch.Tensor, f_fft: torch.Tensor,
               rhs: torch.Tensor, bf16: bool = False):
    """Divide-after filterbank for one frame: Q (B, N), rhs (B, 4, F) ->
    (Y, Zre, Zim), each (B, N). nan_to_num applies to Y only."""
    if bf16:
        G = fb_gauss_fast(Q, fc, f_fft).to(torch.bfloat16).float()
        rhs = rhs.float()
    else:
        G = fb_gauss(Q, fc, f_fft)
    out = torch.matmul(G, rhs.transpose(-1, -2))             # (B, N, 4)
    den = out[..., 3] + EPS_NORM
    Y = torch.nan_to_num(out[..., 0] / den, nan=0.0, posinf=0.0, neginf=0.0)
    return Y, out[..., 1] / den, out[..., 2] / den


def band_phase(Zre: torch.Tensor, Zim: torch.Tensor,
               eps_mag: float = 1e-3) -> torch.Tensor:
    """Per-band phase: |Z| floored at eps_mag, then atan2 of the
    normalised components."""
    mag = torch.clamp(torch.sqrt(Zre * Zre + Zim * Zim), min=eps_mag)
    return torch.atan2(Zim / mag, Zre / mag)
