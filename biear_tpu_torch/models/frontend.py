"""Adaptive-Q binaural frontends (dual and single controller) and the
fixed-Q path.

Counterpart of ``biear_tpu/models/frontend.py``. All T frames are framed
and transformed at once; only the Q feedback loop runs frame by frame, in
``forward``'s loop over the frontend's ``frame`` method, which streaming
(``serve/streaming.py``) calls on one frame at a time, as the JAX
package's scan bodies ``adaptive_step`` and ``single_step`` serve both.
Each frame builds the Gaussian filterbank for both ears in one (2B) batch
(at batch 512 one frame's G for both ears is ~210 MB in f32).

  * ``DualFrontend``: two independent per-ear controllers (``fb_L``,
    ``fb_R``) on [Y_ctrl, memory] (2N inputs each).
  * ``SingleFrontend``: one shared controller (``q_rnn``, ``q_out``
    directly under ``bifb``) on [YL_ctrl, memL, YR_ctrl, memR] (4N
    inputs) sets one Q for both ears; the (2B) filterbank call repeats Q,
    so its gradient sums over both ears.

Training (``train=True`` with a generator): the controllers' dropout masks
for all frames, both ears and both sites are drawn in one call. Under
the production policy the dual frontend's whole frame loop is one
autograd node with a hand backward (``models/frontend_bwd.py``: bf16
operands, the "custom" VJP without spectra gradients, f32 products);
otherwise the loop of ``frame`` runs under autograd, and the filterbank
is differentiated by the VJP that ``cfg.fb_vjp`` resolves to:
the hand backward ``ops.filterbank.FilterbankFn`` ("custom", which saves
only (B, N)-sized tensors per frame), or plain autograd ("autodiff"),
which would keep every frame's (2B, N, F) G and its intermediates; there
the filterbank call is recomputed in the backward
(``torch.utils.checkpoint``), as the JAX package rematerialises its scan
step (``cfg.remat_frontend``).

Quirks of the reference kept exactly:
  * dual: the Y-memory input is 0.2 * log1p(max(Y, 0)) of the CURRENT
    frame (the dual mode re-creates its memory every frame), detached;
  * single: the per-ear EMA memories persist across frames, updated after
    the controller step as 0.8 mem + 0.2 detach(Y_ctrl);
  * the controller's output layer starts at zero (Q = Q0);
  * Q is clamped to [q_min, q_max] after each update;
  * a nonfinite Q anywhere in a controller's batch resets its Q to Q0 and
    its state to zero (a device-side select, no host sync);
  * freeze_q keeps Q at Q0 and the state (memories included) at zero.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..device import constant_cache, precision_highest
from ..ops.erb import erb_spaced_fc_and_q, make_deltaQ_profile
from ..ops.filterbank import (band_phase, fb_forward, filterbank_apply_rhs,
                              resolve_fb_vjp, stack_rhs)
from ..ops.framing import frame_1s, frame_params, hann_window_periodic
from . import frontend_bwd
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
    """frontend_constants with the arrays as tensors on `device`, copied
    there once per (cfg, device) and shared by every caller (read only):
    a copy per forward would put a host transfer inside every step."""
    return _device_constants(cfg, torch.device(device))


@constant_cache
def _device_constants(cfg: BiEARConfig, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) if isinstance(v, np.ndarray)
            else v for k, v in frontend_constants(cfg).items()}


def frame_spectra(cfg: BiEARConfig, frames: torch.Tensor, c: dict):
    """frames (..., win) -> (Xmag, Xre, Xim), each (..., F).

    "fft": rFFT of the Hann-windowed, zero-padded frames. "matmul": the
    windowed DFT bases as one f32 product each (TF32 off on the card,
    under every MATMUL_PRECISION)."""
    if cfg.use_dft_matmul:
        with precision_highest():
            re = frames @ c["dft_re"]
            im = frames @ c["dft_im"]
        return torch.sqrt(re * re + im * im), re, im
    X = torch.fft.rfft(frames * c["window"], n=cfg.n_fft)
    return X.abs(), X.real, X.imag


def spectra(cfg: BiEARConfig, wav: torch.Tensor, c: dict):
    """wav (B, Nsamp) -> (Xmag, Xre, Xim), each (B, T, F)."""
    frames = frame_1s(wav, cfg.fs, cfg.timesteps, c["win"], c["hop"])
    return frame_spectra(cfg, frames, c)


def make_q_out(cfg: BiEARConfig) -> nn.Sequential:
    """[Linear, LN, SiLU, Dropout] x2 and Linear(H -> N); indices 0, 1, 4,
    5, 8 are the reference's."""
    H = cfg.ctrl_hidden
    return nn.Sequential(
        nn.Linear(H, H), nn.LayerNorm(H), nn.SiLU(),
        nn.Dropout(cfg.ctrl_dropout),
        nn.Linear(H, H), nn.LayerNorm(H), nn.SiLU(),
        nn.Dropout(cfg.ctrl_dropout),
        nn.Linear(H, cfg.n_bands))


def controller_update(q_rnn: GRU, q_out: nn.Sequential, rate: float,
                      h: torch.Tensor, feat: torch.Tensor, drops=None):
    """One controller update: returns (delta in [-1, 1], new hidden).
    drops: the keep-masks (2, B, H) of the two dropout sites, or None for
    none (the nn.Dropout modules at indices 3 and 7 are never called)."""
    h = q_rnn.step(feat, h)
    z = q_out[2](q_out[1](q_out[0](h)))
    if drops is not None:
        z = dropout_apply(drops[0], z, rate)
    z = q_out[6](q_out[5](q_out[4](z)))
    if drops is not None:
        z = dropout_apply(drops[1], z, rate)
    return torch.tanh(q_out[8](z)), h


class Controller(nn.Module):
    """Q-controller: GRU(n_in -> H) and ``make_q_out``."""

    def __init__(self, cfg: BiEARConfig, n_in: int):
        super().__init__()
        self.rate = cfg.ctrl_dropout
        self.q_rnn = GRU(n_in, cfg.ctrl_hidden)
        self.q_out = make_q_out(cfg)

    def forward(self, h: torch.Tensor, feat: torch.Tensor, drops=None):
        return controller_update(self.q_rnn, self.q_out, self.rate, h, feat,
                                 drops)


def q_unclamped(cfg: BiEARConfig, c: dict,
                delta: torch.Tensor) -> torch.Tensor:
    """The next Q from the controller's delta, before the clamp."""
    if cfg.deltaQ_mode.lower() == "relative":
        return c["Q0"][None] * (1.0 + c["deltaQ_vec"][None] * delta)
    return c["Q0"][None] + c["deltaQ_vec"][None] * delta


def next_q(cfg: BiEARConfig, c: dict, delta: torch.Tensor) -> torch.Tensor:
    return torch.clamp(q_unclamped(cfg, c, delta), cfg.q_min, cfg.q_max)


def finite_reset(Q: torch.Tensor, h: torch.Tensor, Q0: torch.Tensor):
    """If any Q entry is nonfinite, reset Q to Q0 and h to zeros, for the
    whole batch; decided on the device (no .item())."""
    ok = torch.isfinite(Q).all()
    return (torch.where(ok, Q, Q0.expand_as(Q)),
            torch.where(ok, h, torch.zeros_like(h)))


def adaptive_step(ctrl: Controller, cfg: BiEARConfig, c: dict, Q, h, Y,
                  drops=None):
    """Controller half of one dual-mode frame for one ear, from its band
    energy Y."""
    Y_ctrl = torch.log1p(torch.clamp(Y, min=0.0))
    feat = torch.cat([Y_ctrl, 0.2 * Y_ctrl.detach()], dim=-1)
    delta, h = ctrl(h, feat, drops)
    return finite_reset(next_q(cfg, c, delta), h, c["Q0"][None])


def fixed_forward(cfg: BiEARConfig, c: dict, Xmag, Xre, Xim):
    """Fixed-Q filterbank over the whole spectrogram with the precomputed
    clamped-Q0 matrix, under the same f32/bf16 operand policy (f32 sums,
    TF32 off on the card)."""
    W = c["W_fixed"]                                     # (N, F)
    if cfg.fb_w_dtype == "bfloat16":
        rnd = lambda a: a.to(torch.bfloat16).float()
        W, Xmag, Xre, Xim = rnd(W), rnd(Xmag), rnd(Xre), rnd(Xim)
    with precision_highest():
        Ym, Zre, Zim = Xmag @ W.T, Xre @ W.T, Xim @ W.T
    Y = torch.nan_to_num(Ym, nan=0.0, posinf=0.0, neginf=0.0)
    phase = band_phase(Zre, Zim)
    B, T = Xmag.shape[:2]
    Qc = torch.clamp(c["Q0"], cfg.q_min, cfg.q_max)
    return Y, Qc.expand(B, T, cfg.n_bands), phase


class _Frontend(nn.Module):
    """Spectra, the fixed-Q path and the frame loop shared by both
    adaptive frontends. A subclass defines ``init_carry``, ``mask_shape``,
    ``controllers`` and ``frame``; ``STREAM_AXIS`` is the batch axis of
    its carry."""

    STREAM_AXIS = 0

    def __init__(self, cfg: BiEARConfig):
        super().__init__()
        self.cfg = cfg

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
        masks = None
        if train and gen is not None and cfg.ctrl_dropout > 0.0:
            masks = dropout_masks(gen, cfg.ctrl_dropout,
                                  (T, *self.mask_shape(B)))
        if frontend_bwd.applies(self, rhs):
            Y, Q, phase = frontend_bwd.recurrence(self, c, rhs, masks)
        else:
            Y, Q, phase = self.frame_loop(c, rhs, masks)
        return Y[0], Y[1], Q[0], Q[1], phase[0], phase[1]

    def frame_loop(self, c: dict, rhs: torch.Tensor, masks=None) -> tuple:
        """The loop of ``frame`` over rhs (T, 2B, 4, F) with keep-masks
        (T, ...) or None: (Y, Q, phase), each (2, B, T, N)."""
        B = rhs.shape[1] // 2
        carry = self.init_carry(c, B, rhs.device)
        fb = self.filterbank(c)
        Ys, Qs, phases = [], [], []
        for t in range(rhs.shape[0]):
            carry, (Y, Q, phase) = self.frame(
                c, fb, carry, rhs[t], None if masks is None else masks[t])
            Ys.append(Y)
            Qs.append(Q)
            phases.append(phase)
        return tuple(torch.stack(a, dim=2) for a in (Ys, Qs, phases))

    def filterbank(self, c: dict):
        """(Q, rhs) -> (Y, Zre, Zim) for one frame: the plain forward
        without autograd, else the VJP cfg.fb_vjp resolves to."""
        cfg = self.cfg
        bf16 = cfg.fb_w_dtype == "bfloat16"
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


class DualFrontend(_Frontend):
    """Two independent per-ear Q-controllers (``fb_L``, ``fb_R``), or none
    when the frontend Q is fixed. The carry is ear-stacked: (Q (2, B, N),
    h (2, B, H))."""

    STREAM_AXIS = 1

    def __init__(self, cfg: BiEARConfig):
        super().__init__(cfg)
        if not cfg.fixed_frontend_q:
            self.fb_L = Controller(cfg, 2 * cfg.n_bands)
            self.fb_R = Controller(cfg, 2 * cfg.n_bands)

    def controllers(self) -> list:
        """The modules that own a ``q_out``."""
        return [] if self.cfg.fixed_frontend_q else [self.fb_L, self.fb_R]

    def init_carry(self, c: dict, B: int, device) -> tuple:
        cfg = self.cfg
        return (c["Q0"].expand(2, B, cfg.n_bands),
                torch.zeros((2, B, cfg.ctrl_hidden), device=device))

    def mask_shape(self, B: int) -> tuple:
        """Per frame: [ear, site] -> (B, H)."""
        return (2, 2, B, self.cfg.ctrl_hidden)

    def frame(self, c: dict, fb, carry: tuple, rhs: torch.Tensor,
              drops=None):
        """One frame, both ears: rhs (2B, 4, F) -> (carry', (Y, Q, phase)),
        each output (2, B, N), Q the one this frame was filtered with."""
        cfg = self.cfg
        Q, h = carry
        B = Q.shape[1]
        Y, Zre, Zim = fb(Q.reshape(2 * B, -1), rhs)
        Y = Y.reshape(2, B, -1)
        out = (Y, Q, band_phase(Zre, Zim).reshape(2, B, -1))
        if cfg.freeze_q:
            return carry, out
        dL = dR = None
        if drops is not None:
            dL, dR = drops[0], drops[1]
        QL, hL = adaptive_step(self.fb_L, cfg, c, Q[0], h[0], Y[0], dL)
        QR, hR = adaptive_step(self.fb_R, cfg, c, Q[1], h[1], Y[1], dR)
        return (torch.stack([QL, QR]), torch.stack([hL, hR])), out


class SingleFrontend(_Frontend):
    """One shared Q-controller for both ears. Its parameters sit directly
    on this module (``q_rnn``, ``q_out``: ``bifb.q_rnn.*`` in a reference
    checkpoint); none when the frontend Q is fixed. The carry is (Q (B, N),
    h (B, H), memL (B, N), memR (B, N))."""

    BETA = 0.8

    def __init__(self, cfg: BiEARConfig):
        super().__init__(cfg)
        if not cfg.fixed_frontend_q:
            self.rate = cfg.ctrl_dropout
            self.q_rnn = GRU(4 * cfg.n_bands, cfg.ctrl_hidden)
            self.q_out = make_q_out(cfg)

    def controllers(self) -> list:
        return [] if self.cfg.fixed_frontend_q else [self]

    def init_carry(self, c: dict, B: int, device) -> tuple:
        cfg = self.cfg
        zeros = lambda n: torch.zeros((B, n), device=device)
        return (c["Q0"].expand(B, cfg.n_bands), zeros(cfg.ctrl_hidden),
                zeros(cfg.n_bands), zeros(cfg.n_bands))

    def mask_shape(self, B: int) -> tuple:
        """Per frame: [site] -> (B, H)."""
        return (2, B, self.cfg.ctrl_hidden)

    def frame(self, c: dict, fb, carry: tuple, rhs: torch.Tensor,
              drops=None):
        """One frame, both ears through one (2B) filterbank call with Q
        repeated: rhs (2B, 4, F) -> (carry', (Y, Q, phase)), each output
        (2, B, N)."""
        cfg = self.cfg
        Q, h, memL, memR = carry
        B = Q.shape[0]
        Y, Zre, Zim = fb(torch.cat([Q, Q]), rhs)
        Y = Y.reshape(2, B, -1)
        out = (Y, Q.expand(2, B, cfg.n_bands),
               band_phase(Zre, Zim).reshape(2, B, -1))
        if cfg.freeze_q:
            zero = torch.zeros_like
            return (c["Q0"].expand_as(Q), zero(h), zero(memL),
                    zero(memR)), out
        YL_ctrl = torch.log1p(torch.clamp(Y[0], min=0.0))
        YR_ctrl = torch.log1p(torch.clamp(Y[1], min=0.0))
        feat = torch.cat([YL_ctrl, memL, YR_ctrl, memR], dim=-1)
        delta, h = controller_update(self.q_rnn, self.q_out, self.rate, h,
                                     feat, drops)
        Qn, h = finite_reset(next_q(cfg, c, delta), h, c["Q0"][None])
        beta = self.BETA
        memL = beta * memL + (1.0 - beta) * YL_ctrl.detach()
        memR = beta * memR + (1.0 - beta) * YR_ctrl.detach()
        return (Qn, h, memL, memR), out


def auralnet_fb(cfg: BiEARConfig, wav: torch.Tensor, c: dict) -> torch.Tensor:
    """AuralNet's fixed filterbank: wav (B, Nsamp) -> band energies Y (B,
    T, N), the magnitude spectra times the clamped-Q0 matrix ``W_fixed``
    in f32 under either policy (TF32 off on the card), then nan_to_num.
    No phase (JAX ``auralnet_fb``)."""
    Xmag = spectra(cfg, wav, c)[0]
    with precision_highest():
        Y = Xmag @ c["W_fixed"].T
    return torch.nan_to_num(Y, nan=0.0, posinf=0.0, neginf=0.0)


def make_frontend(cfg: BiEARConfig) -> _Frontend:
    """``SingleFrontend`` for controller_mode "single", else
    ``DualFrontend`` (the JAX package's dispatch)."""
    return (SingleFrontend if cfg.controller_mode == "single"
            else DualFrontend)(cfg)
