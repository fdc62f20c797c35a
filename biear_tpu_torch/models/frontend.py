"""Adaptive-Q binaural frontend (dual controller) and the fixed-Q path.

Counterpart of ``biear_tpu/models/frontend.py`` in eval mode. All T frames
are framed and transformed at once; only the Q feedback loop runs frame by
frame. Each frame builds the Gaussian filterbank for both ears in one
batch and drops it before the next frame (at batch 512 one frame's G for
both ears is ~210 MB in f32).

Quirks of the reference kept exactly:
  * the Y-memory input is 0.2 * log1p(max(Y, 0)) of the CURRENT frame
    (the dual mode re-creates its memory every frame);
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
from ..ops.filterbank import band_phase, fb_forward, stack_rhs
from ..ops.framing import frame_1s, frame_params, hann_window_periodic
from .config import BiEARConfig
from .layers import GRU


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
        self.q_rnn = GRU(n_in, H)
        self.q_out = nn.Sequential(
            nn.Linear(H, H), nn.LayerNorm(H), nn.SiLU(),
            nn.Dropout(cfg.ctrl_dropout),
            nn.Linear(H, H), nn.LayerNorm(H), nn.SiLU(),
            nn.Dropout(cfg.ctrl_dropout),
            nn.Linear(H, cfg.n_bands))

    def forward(self, h: torch.Tensor, feat: torch.Tensor):
        """One update: returns (delta in [-1, 1], new hidden)."""
        h = self.q_rnn.step(feat, h)
        return torch.tanh(self.q_out(h)), h


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


def adaptive_step(ctrl: Controller, cfg: BiEARConfig, c: dict, Q, h, Y):
    """Controller half of one frame for one ear, from its band energy Y."""
    Y_ctrl = torch.log1p(torch.clamp(Y, min=0.0))
    feat = torch.cat([Y_ctrl, 0.2 * Y_ctrl], dim=-1)
    delta, h = ctrl(h, feat)
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

    def forward(self, wavL: torch.Tensor, wavR: torch.Tensor):
        """Returns (YL, YR, QL, QR, phaseL, phaseR), each (B, T, N)."""
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
        Ys, Qs, phases = [], [], []
        for t in range(T):
            Y, Zre, Zim = fb_forward(Q.reshape(2 * B, -1), c["fc"],
                                     c["f_fft"], rhs[t], bf16)
            Y = Y.reshape(2, B, -1)
            Ys.append(Y)
            Qs.append(Q)
            phases.append(band_phase(Zre, Zim).reshape(2, B, -1))
            if cfg.freeze_q:
                continue
            QL, hL = adaptive_step(self.fb_L, cfg, c, Q[0], h[0], Y[0])
            QR, hR = adaptive_step(self.fb_R, cfg, c, Q[1], h[1], Y[1])
            Q, h = torch.stack([QL, QR]), torch.stack([hL, hR])
        Y, Q, phase = (torch.stack(a, dim=2) for a in (Ys, Qs, phases))
        return Y[0], Y[1], Q[0], Q[1], phase[0], phase[1]
