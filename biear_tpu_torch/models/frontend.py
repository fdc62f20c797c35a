"""Adaptive-Q binaural frontend (dual controller) and the fixed-Q path.

Counterpart of ``biear_tpu/models/frontend.py``. All T frames are framed
and transformed at once; only the Q feedback loop runs frame by frame.
Each frame builds the Gaussian filterbank for both ears in one batch (at
batch 512 one frame's G for both ears is ~210 MB in f32).

Training (``train=True`` with a generator): the controllers' dropout masks
for all frames, both ears and both sites are drawn in one call, and the
filterbank is differentiated by the VJP that ``cfg.fb_vjp`` resolves to:
the hand backward ``ops.filterbank.FilterbankFn`` ("custom", which saves
only (B, N)-sized tensors per frame), or plain autograd ("autodiff"),
which would keep every frame's (2B, N, F) G and its intermediates; there
the filterbank call is recomputed in the backward
(``torch.utils.checkpoint``), as the JAX package rematerialises its scan
step (``cfg.remat_frontend``).

Quirks of the reference kept exactly:
  * the Y-memory input is 0.2 * log1p(max(Y, 0)) of the CURRENT frame
    (the dual mode re-creates its memory every frame), detached;
  * the controller's output layer starts at zero (Q = Q0);
  * Q is clamped to [q_min, q_max] after each update;
  * a nonfinite Q anywhere in an ear's batch resets that ear's Q to Q0
    and its controller state to zero (a device-side select, no host sync).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..ops.erb import erb_spaced_fc_and_q, make_deltaQ_profile
from ..ops.filterbank import (band_phase, fb_forward, filterbank_apply_rhs,
                              resolve_fb_vjp, stack_rhs)
from ..ops.framing import frame_1s, frame_params, hann_window_periodic
from .config import BiEARConfig
from .layers import GRU, dropout_apply, dropout_masks


@functools.lru_cache(maxsize=None)
def frontend_constants(cfg: BiEARConfig) -> dict:
    """Static per-config constants, as numpy arrays (float32 unless ints)."""
    fc, Q0 = erb_spaced_fc_and_q(cfg.n_bands, cfg.fmin, cfg.fmax_eff,
                                 erb_factor=1.019)
    deltaQ_vec = make_deltaQ_profile(fc, cfg.deltaQ_base,
                                     cfg.deltaQ_low_factor,
                                     cfg.deltaQ_high_factor)
    win, hop = frame_params(cfg.fs, cfg.timesteps, cfg.hop_ratio)
    f_fft = np.linspace(0.0, cfg.f_nyq, cfg.n_freq).astype(np.float32)

    # fixed-Q filterbank matrix, row-normalised like the adaptive one
    Qc = np.clip(Q0, cfg.q_min, cfg.q_max)
    bw = (fc / (Qc + 1e-8))[:, None] + 1e-8
    W = np.exp(-0.5 * ((f_fft[None, :] - fc[:, None]) / bw) ** 2)
    W = W / (W.sum(-1, keepdims=True) + 1e-8)
    W_fixed = np.nan_to_num(W).astype(np.float32)

    # windowed DFT bases: rfft(pad(hann * x, n_fft))[k]
    #   = sum_{n<win} hann[n] x[n] e^{-2i pi k n / n_fft}
    window = hann_window_periodic(win)
    n = np.arange(win, dtype=np.float64)[:, None]
    k = np.arange(cfg.n_freq, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * n * k / cfg.n_fft
    w64 = window[:, None].astype(np.float64)
    return {
        "fc": fc, "Q0": Q0, "deltaQ_vec": deltaQ_vec, "f_fft": f_fft,
        "win": win, "hop": hop, "window": window, "W_fixed": W_fixed,
        "dft_re": (w64 * np.cos(ang)).astype(np.float32),
        "dft_im": (w64 * np.sin(ang)).astype(np.float32),
    }


def device_constants(cfg: BiEARConfig, device) -> dict:
    """frontend_constants with the arrays as tensors on `device`."""
    return {k: torch.as_tensor(v, device=device) if isinstance(v, np.ndarray)
            else v for k, v in frontend_constants(cfg).items()}


def spectra(cfg: BiEARConfig, wav: torch.Tensor, c: dict):
    """wav (B, Nsamp) -> (Xmag, Xre, Xim), each (B, T, F).

    "fft": rFFT of the Hann-windowed, zero-padded frames. "matmul": the
    windowed DFT bases as one f32 product each (TF32 off on the card)."""
    frames = frame_1s(wav, cfg.fs, cfg.timesteps, c["win"], c["hop"])
    if cfg.use_dft_matmul:
        re = frames @ c["dft_re"]
        im = frames @ c["dft_im"]
        return torch.sqrt(re * re + im * im), re, im
    X = torch.fft.rfft(frames * c["window"], n=cfg.n_fft)
    return X.abs(), X.real, X.imag


class Controller(nn.Module):
    """Q-controller: GRU(2N -> H), then [Linear, LN, SiLU, Dropout] x2 and
    Linear(H -> N). Indices 0, 1, 4, 5, 8 of ``q_out`` are the reference's."""

    def __init__(self, cfg: BiEARConfig, n_in: int):
        super().__init__()
        H = cfg.ctrl_hidden
        self.rate = cfg.ctrl_dropout
        self.q_rnn = GRU(n_in, H)
        self.q_out = nn.Sequential(
            nn.Linear(H, H), nn.LayerNorm(H), nn.SiLU(),
            nn.Dropout(cfg.ctrl_dropout),
            nn.Linear(H, H), nn.LayerNorm(H), nn.SiLU(),
            nn.Dropout(cfg.ctrl_dropout),
            nn.Linear(H, cfg.n_bands))

    def forward(self, h: torch.Tensor, feat: torch.Tensor, drops=None):
        """One update: returns (delta in [-1, 1], new hidden). drops: the
        keep-masks (2, B, H) of the two dropout sites, or None for none
        (the nn.Dropout modules at indices 3 and 7 are never called)."""
        h = self.q_rnn.step(feat, h)
        q = self.q_out
        z = q[2](q[1](q[0](h)))
        if drops is not None:
            z = dropout_apply(drops[0], z, self.rate)
        z = q[6](q[5](q[4](z)))
        if drops is not None:
            z = dropout_apply(drops[1], z, self.rate)
        return torch.tanh(q[8](z)), h


def next_q(cfg: BiEARConfig, c: dict, delta: torch.Tensor) -> torch.Tensor:
    if cfg.deltaQ_mode.lower() == "relative":
        Q = c["Q0"][None] * (1.0 + c["deltaQ_vec"][None] * delta)
    else:
        Q = c["Q0"][None] + c["deltaQ_vec"][None] * delta
    return torch.clamp(Q, cfg.q_min, cfg.q_max)


def finite_reset(Q: torch.Tensor, h: torch.Tensor, Q0: torch.Tensor):
    """If any Q entry is nonfinite, reset Q to Q0 and h to zeros, for the
    whole batch; decided on the device (no .item())."""
    ok = torch.isfinite(Q).all()
    return (torch.where(ok, Q, Q0.expand_as(Q)),
            torch.where(ok, h, torch.zeros_like(h)))


def adaptive_step(ctrl: Controller, cfg: BiEARConfig, c: dict, Q, h, Y,
                  drops=None):
    """Controller half of one frame for one ear, from its band energy Y."""
    Y_ctrl = torch.log1p(torch.clamp(Y, min=0.0))
    feat = torch.cat([Y_ctrl, 0.2 * Y_ctrl.detach()], dim=-1)
    delta, h = ctrl(h, feat, drops)
    return finite_reset(next_q(cfg, c, delta), h, c["Q0"][None])


def fixed_forward(cfg: BiEARConfig, c: dict, Xmag, Xre, Xim):
    """Fixed-Q filterbank over the whole spectrogram with the precomputed
    clamped-Q0 matrix, under the same f32/bf16 operand policy."""
    W = c["W_fixed"]                                     # (N, F)
    if cfg.fb_w_dtype == "bfloat16":
        rnd = lambda a: a.to(torch.bfloat16).float()
        W, Xmag, Xre, Xim = rnd(W), rnd(Xmag), rnd(Xre), rnd(Xim)
    Y = torch.nan_to_num(Xmag @ W.T, nan=0.0, posinf=0.0, neginf=0.0)
    phase = band_phase(Xre @ W.T, Xim @ W.T)
    B, T = Xmag.shape[:2]
    Qc = torch.clamp(c["Q0"], cfg.q_min, cfg.q_max)
    return Y, Qc.expand(B, T, cfg.n_bands), phase


class DualFrontend(nn.Module):
    """Two independent per-ear Q-controllers (``fb_L``, ``fb_R``), or none
    when the frontend Q is fixed."""

    def __init__(self, cfg: BiEARConfig):
        super().__init__()
        self.cfg = cfg
        if not cfg.fixed_frontend_q:
            self.fb_L = Controller(cfg, 2 * cfg.n_bands)
            self.fb_R = Controller(cfg, 2 * cfg.n_bands)

    def forward(self, wavL: torch.Tensor, wavR: torch.Tensor,
                gen: torch.Generator | None = None, train: bool = False):
        """Returns (YL, YR, QL, QR, phaseL, phaseR), each (B, T, N).

        train with a generator draws the controller dropout masks."""
        cfg = self.cfg
        c = device_constants(cfg, wavL.device)
        specL = spectra(cfg, wavL, c)
        specR = spectra(cfg, wavR, c)
        if cfg.fixed_frontend_q:
            YL, QL, phL = fixed_forward(cfg, c, *specL)
            YR, QR, phR = fixed_forward(cfg, c, *specR)
            return YL, YR, QL, QR, phL, phR

        bf16 = cfg.fb_w_dtype == "bfloat16"
        B, T = wavL.shape[0], cfg.timesteps
        # (T, 2B, 4, F): both ears batched into every frame's filterbank
        rhs = torch.cat([stack_rhs(*specL, bf16), stack_rhs(*specR, bf16)])
        rhs = rhs.transpose(0, 1)
        Q = c["Q0"].expand(2, B, cfg.n_bands)
        h = wavL.new_zeros((2, B, cfg.ctrl_hidden))
        masks = None                    # [frame, ear, site] -> (B, H)
        if train and gen is not None and cfg.ctrl_dropout > 0.0:
            masks = dropout_masks(gen, cfg.ctrl_dropout,
                                  (T, 2, 2, B, cfg.ctrl_hidden))
        fb = self._filterbank(c, bf16)
        Ys, Qs, phases = [], [], []
        for t in range(T):
            Y, Zre, Zim = fb(Q.reshape(2 * B, -1), rhs[t])
            Y = Y.reshape(2, B, -1)
            Ys.append(Y)
            Qs.append(Q)
            phases.append(band_phase(Zre, Zim).reshape(2, B, -1))
            if cfg.freeze_q:
                continue
            dL = dR = None
            if masks is not None:
                dL, dR = masks[t, 0], masks[t, 1]
            QL, hL = adaptive_step(self.fb_L, cfg, c, Q[0], h[0], Y[0], dL)
            QR, hR = adaptive_step(self.fb_R, cfg, c, Q[1], h[1], Y[1], dR)
            Q, h = torch.stack([QL, QR]), torch.stack([hL, hR])
        Y, Q, phase = (torch.stack(a, dim=2) for a in (Ys, Qs, phases))
        return Y[0], Y[1], Q[0], Q[1], phase[0], phase[1]

    def _filterbank(self, c: dict, bf16: bool):
        """(Q, rhs) -> (Y, Zre, Zim) for one frame: the plain forward
        without autograd, else the VJP cfg.fb_vjp resolves to."""
        cfg = self.cfg
        fc, f_fft = c["fc"], c["f_fft"]
        if not torch.is_grad_enabled():
            return lambda Q, rhs: fb_forward(Q, fc, f_fft, rhs, bf16)
        vjp = resolve_fb_vjp(cfg.fb_vjp)
        if vjp == "autodiff" and cfg.remat_frontend:
            from torch.utils.checkpoint import checkpoint
            return lambda Q, rhs: checkpoint(fb_forward, Q, fc, f_fft, rhs,
                                             bf16, use_reentrant=False)
        return lambda Q, rhs: filterbank_apply_rhs(Q, fc, f_fft, rhs, bf16,
                                                   vjp, cfg.fb_x_grad)
