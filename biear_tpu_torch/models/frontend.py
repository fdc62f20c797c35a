"""Adaptive-Q binaural frontends (dual and single controller) and the
fixed-Q path.

Counterpart of ``biear_tpu/models/frontend.py``. All T frames are framed
and transformed at once; only the Q feedback loop runs frame by frame.
Under the bf16 policy ``dft_mode`` "auto" takes the spectra as the DFT
product on the CPU and as one launch of ``kernels/spectra.cu`` on the card
(``spectra_on_kernel``), which writes the adaptive frontends' bf16 operand
for both ears at once (``frame_rhs``) or one ear's f32 spectra.
A frame is the frontend's ``filter`` (both ears' filterbank with the
carry's Q, and the band phase) then its ``step`` (the controller step of
``models/controller.py``, written once, for the next frame's Q; the dual
frontend's, on the card without gradients, both ears in one launch of
``kernels/controller_fwd.cu``).
``frame_loop`` runs them over the T frames, and ``frame``, one hop of
streaming (``serve/streaming.py``), runs both once, as the JAX package's
scan bodies ``adaptive_step`` and ``single_step`` serve both. Each frame
builds the Gaussian filterbank for both ears in one (2B) batch (at batch
512 one frame's G for both ears is ~210 MB in f32).

  * ``DualFrontend``: two independent per-ear controllers (``fb_L``,
    ``fb_R``) on [Y_ctrl, memory] (2N inputs each).
  * ``SingleFrontend``: one shared controller (``q_rnn``, ``q_out``
    directly under ``bifb``) on [YL_ctrl, memL, YR_ctrl, memR] (4N
    inputs) sets one Q for both ears; the (2B) filterbank call repeats Q,
    so its gradient sums over both ears.

Training (``train=True`` with a generator): the controllers' dropout masks
for all frames, both ears and both sites are drawn in one call. Under
the production policy (``_Frontend.hand_backward``) either frontend's
whole ``frame_loop`` is one autograd node with a hand backward
(``models/frontend_bwd.py``: bf16 operands, the "custom" VJP without
spectra gradients, f32 products); otherwise ``frame_loop`` runs under
autograd, and the filterbank is differentiated by the VJP that
``cfg.fb_vjp`` resolves to: the hand backward
``ops.filterbank.FilterbankFn`` ("custom", which saves only (B, N)-sized
tensors per frame), or plain autograd ("autodiff"), which would keep
every frame's (2B, N, F) G and its intermediates; there the filterbank
call is recomputed in the backward (``torch.utils.checkpoint``), as the
JAX package rematerialises its scan step (``cfg.remat_frontend``).
``forward`` runs the frames inside a ``frontend.loop`` span whose ``path``
names the loop it took, and hands its outputs to ``trace.frontend_marks``
(the ``frontend`` and ``frontend_grad`` stage marks of a train chunk).

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

from .. import trace
from ..device import constant_cache, precision_highest
from ..ops.erb import erb_spaced_fc_and_q, make_deltaQ_profile
from ..ops.filterbank import (band_phase, fb_forward, filterbank_apply_rhs,
                              resolve_fb_vjp)
from ..ops.framing import frame_1s, frame_params, hann_window_periodic
from ..ops.spectra import (dft_plain, fft_twiddles, rhs_cuda, rhs_plain,
                           spectra_cuda)
from . import frontend_bwd
from .config import BiEARConfig
from .controller import (Controller, controller_params, controller_step,
                         dual_step_cuda, f32_products, make_q_out,
                         takes_kernel)
from .layers import GRU, dropout_masks


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
    """frontend_constants and the spectra kernel's twiddles
    (``ops/spectra.py::fft_twiddles``) with the arrays as tensors on
    `device`, copied there once per (cfg, device) and shared by every
    caller (read only): a copy per forward would put a host transfer
    inside every step."""
    return _device_constants(cfg, torch.device(device))


@constant_cache
def _device_constants(cfg: BiEARConfig, device: torch.device) -> dict:
    consts = {**frontend_constants(cfg), **fft_twiddles(cfg.n_fft)}
    return {k: torch.as_tensor(v, device=device) if isinstance(v, np.ndarray)
            else v for k, v in consts.items()}


def spectra_on_kernel(cfg: BiEARConfig, x: torch.Tensor) -> bool:
    """Whether the spectra of frames `x` run on ``kernels/spectra.cu``:
    dft_mode "auto" under the bf16 policy (where "auto" means the DFT
    product) on a CUDA tensor. The CPU keeps the product, the f32 policy
    the rFFT, and an explicit "fft" or "matmul" its own path."""
    return cfg.dft_mode == "auto" and cfg.use_dft_matmul and x.is_cuda


def frame_spectra(cfg: BiEARConfig, frames: torch.Tensor, c: dict,
                  mag_only: bool = False):
    """frames (..., win) -> (Xmag, Xre, Xim), each (..., F).

    "fft": rFFT of the Hann-windowed, zero-padded frames. "matmul": the
    windowed DFT bases as one f32 product each (TF32 off on the card,
    under every MATMUL_PRECISION; ``ops/spectra.py::dft_plain``). "auto"
    under the bf16 policy: the product on the CPU, one launch of
    ``kernels/spectra.cu`` on the card (``spectra_on_kernel``), which with
    `mag_only` writes Xmag alone and returns (Xmag, None, None)."""
    if spectra_on_kernel(cfg, frames):
        return spectra_cuda(frames, c, cfg.n_fft, mag_only)
    if cfg.use_dft_matmul:
        return dft_plain(frames, c["dft_re"], c["dft_im"])
    X = torch.fft.rfft(frames * c["window"], n=cfg.n_fft)
    return X.abs(), X.real, X.imag


def frames_of(cfg: BiEARConfig, wav: torch.Tensor, c: dict) -> torch.Tensor:
    """wav (B, Nsamp) -> its T frames (B, T, win), a view where no padding
    is needed."""
    return frame_1s(wav, cfg.fs, cfg.timesteps, c["win"], c["hop"])


def spectra(cfg: BiEARConfig, wav: torch.Tensor, c: dict,
            mag_only: bool = False):
    """wav (B, Nsamp) -> (Xmag, Xre, Xim), each (B, T, F); `mag_only` as
    for frame_spectra."""
    return frame_spectra(cfg, frames_of(cfg, wav, c), c, mag_only)


def frame_rhs(cfg: BiEARConfig, framesL: torch.Tensor,
              framesR: torch.Tensor, c: dict) -> torch.Tensor:
    """Both ears' filterbank operand [mag, re, im, 1] from their frames:
    (T, 2B, 4, F) from frames (B, T, win) (the frame axis first, a
    transposed view of the (2B, T, 4, F) stack), (2B, 4, F) from one frame
    an ear (B, win); bf16 under the bf16 policy. Where the spectra run on
    the kernel (``spectra_on_kernel``), one launch writes it for both
    ears; elsewhere ``ops/spectra.py::rhs_plain`` of frame_spectra."""
    if spectra_on_kernel(cfg, framesL):
        return rhs_cuda(framesL, framesR, c, cfg.n_fft)
    return rhs_plain(frame_spectra(cfg, framesL, c),
                     frame_spectra(cfg, framesR, c),
                     cfg.fb_w_dtype == "bfloat16")


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
    """Spectra, the fixed-Q path, the frame loop and its hand backward
    shared by both adaptive frontends. A subclass defines ``init_carry``,
    ``mask_shape``, ``controllers``, ``filter``, ``step`` (whose saved
    sets are one ``Saved`` per controller) and ``y_cols``; ``STREAM_AXIS``
    is the batch axis of its carry."""

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
        if cfg.fixed_frontend_q:
            YL, QL, phL = fixed_forward(cfg, c, *spectra(cfg, wavL, c))
            YR, QR, phR = fixed_forward(cfg, c, *spectra(cfg, wavR, c))
            return trace.frontend_marks(YL, YR, QL, QR, phL, phR)

        B, T = wavL.shape[0], cfg.timesteps
        # (T, 2B, 4, F): both ears batched into every frame's filterbank
        rhs = frame_rhs(cfg, frames_of(cfg, wavL, c), frames_of(cfg, wavR, c),
                        c)
        masks = None
        if train and gen is not None and cfg.ctrl_dropout > 0.0:
            masks = dropout_masks(gen, cfg.ctrl_dropout,
                                  (T, *self.mask_shape(B)))
        path = self.loop_path(rhs)
        with trace.span("frontend.loop", path=path):
            Y, Q, phase = (self.recurrence if path == "recurrence"
                           else self.frame_loop)(c, rhs, masks)
        Y, Q, phase = trace.frontend_marks(Y, Q, phase)
        return Y[0], Y[1], Q[0], Q[1], phase[0], phase[1]

    def hand_backward(self, x: torch.Tensor) -> bool:
        """Whether the frame loop on `x` runs as ``RecurrenceFn`` (one
        autograd node, the hand reverse recurrence): adaptive Q (not
        frozen), bf16 filterbank operands, the "custom" VJP without
        spectra gradients ("bf16|noxg"), f32 products and autograd
        recording."""
        cfg = self.cfg
        return (not cfg.freeze_q and cfg.fb_w_dtype == "bfloat16"
                and resolve_fb_vjp(cfg.fb_vjp) == "custom"
                and not cfg.fb_x_grad and torch.is_grad_enabled()
                and any(p.requires_grad for p in self.parameters())
                and f32_products(x))

    def loop_path(self, rhs: torch.Tensor) -> str:
        """How forward runs the frames on `rhs`: "recurrence"
        (``RecurrenceFn``) where ``hand_backward`` holds, else "autograd"
        (``frame_loop`` recorded by autograd) or "no_grad"."""
        if self.hand_backward(rhs):
            return "recurrence"
        return "autograd" if torch.is_grad_enabled() else "no_grad"

    def recurrence(self, c: dict, rhs: torch.Tensor, masks) -> tuple:
        """``frame_loop`` through ``RecurrenceFn``: rhs (T, 2B, 4, F),
        masks (T, *mask_shape) keep-masks or None -> (Y, Q, phase), each
        (2, B, T, N)."""
        params = [p for ctrl in self.controllers()
                  for p in controller_params(ctrl)]
        return frontend_bwd.RecurrenceFn.apply(self, c, rhs, masks, *params)

    def frame_loop(self, c: dict, rhs: torch.Tensor, masks=None, fb=None,
                   sink: list | None = None) -> tuple:
        """The loop of ``frame``'s two halves, ``filter`` and ``step``,
        over rhs (T, 2B, 4, F) with keep-masks (T, ...) or None: (Y, Q,
        phase), each (2, B, T, N). The last frame's controller step is
        not run: nothing reads its carry. fb:
        the filterbank, ``filterbank(c)`` if None; sink: a list that gets
        what each controller step saved (``step``)."""
        T, B = rhs.shape[0], rhs.shape[1] // 2
        carry = self.init_carry(c, B, rhs.device)
        fb = fb or self.filterbank(c)
        outs = []
        for t in range(T):
            outs.append(self.filter(fb, carry, rhs[t]))
            if t == T - 1:
                break
            carry, saved = self.step(c, carry, outs[-1][0],
                                     None if masks is None else masks[t])
            if sink is not None:
                sink.append(saved)
        return tuple(torch.stack(a, dim=2) for a in zip(*outs))

    def frame(self, c: dict, fb, carry: tuple, rhs: torch.Tensor,
              drops=None):
        """One frame, both ears: rhs (2B, 4, F) -> (carry', (Y, Q, phase)),
        each output (2, B, N), Q the one this frame was filtered with."""
        out = self.filter(fb, carry, rhs)
        return self.step(c, carry, out[0], drops)[0], out

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

    def filter(self, fb, carry: tuple, rhs: torch.Tensor) -> tuple:
        """Both ears through one (2B) filterbank call with the carry's Q:
        (Y, Q, phase), each (2, B, N)."""
        Q = carry[0]
        B = Q.shape[1]
        Y, Zre, Zim = fb(Q.reshape(2 * B, -1), rhs)
        return (Y.reshape(2, B, -1), Q,
                band_phase(Zre, Zim).reshape(2, B, -1))

    def step(self, c: dict, carry: tuple, Y: torch.Tensor, drops=None):
        """Each ear's controller step on [Y_ctrl, 0.2 * Y_ctrl] of its band
        energy Y (2, B, N), the memory input detached: (carry', (left's
        Saved, right's)); with Q frozen, (carry, None). On the card with
        gradients off and f32 products (``controller.takes_kernel``) both
        ears' steps are one launch of ``kernels/controller_fwd.cu``;
        elsewhere ``controller_step`` once an ear."""
        if self.cfg.freeze_q:
            return carry, None
        ears = [controller_params(ctrl) for ctrl in self.controllers()]
        if takes_kernel(Y):
            Q, h, saved = dual_step_cuda(self.cfg, c, carry[1], Y, drops,
                                         ears)
            return (Q, h), saved
        steps = []
        for e, params in enumerate(ears):
            Y_ctrl = torch.log1p(torch.clamp(Y[e], min=0.0))
            feat = torch.cat([Y_ctrl, 0.2 * Y_ctrl.detach()], dim=-1)
            steps.append(controller_step(
                self.cfg, c, carry[1][e], feat,
                None if drops is None else drops[e], params))
        (QL, hL, sL), (QR, hR, sR) = steps
        return (torch.stack([QL, QR]), torch.stack([hL, hR])), (sL, sR)

    def y_cols(self) -> tuple:
        """The feature columns at which each controller's step reads the
        ears' Y: its own ear's at 0 of [Y_ctrl, 0.2 * Y_ctrl]."""
        return (0,)


class SingleFrontend(_Frontend):
    """One shared Q-controller for both ears. Its parameters sit directly
    on this module (``q_rnn``, ``q_out``: ``bifb.q_rnn.*`` in a reference
    checkpoint); none when the frontend Q is fixed. The carry is (Q (B, N),
    h (B, H), memL (B, N), memR (B, N))."""

    BETA = 0.8

    def __init__(self, cfg: BiEARConfig):
        super().__init__(cfg)
        if not cfg.fixed_frontend_q:
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

    def filter(self, fb, carry: tuple, rhs: torch.Tensor) -> tuple:
        """Both ears through one (2B) filterbank call with Q repeated:
        (Y, Q, phase), each (2, B, N)."""
        Q = carry[0]
        B = Q.shape[0]
        Y, Zre, Zim = fb(torch.cat([Q, Q]), rhs)
        return (Y.reshape(2, B, -1), Q.expand(2, B, self.cfg.n_bands),
                band_phase(Zre, Zim).reshape(2, B, -1))

    def step(self, c: dict, carry: tuple, Y: torch.Tensor, drops=None):
        """The controller step on [YL_ctrl, memL, YR_ctrl, memR], then the
        memories' EMA of the detached Y_ctrl: (carry', (Saved,)); with Q
        frozen, (the zero carry at Q0, None)."""
        Q, h, memL, memR = carry
        if self.cfg.freeze_q:
            zero = torch.zeros_like
            return (c["Q0"].expand_as(Q), zero(h), zero(memL),
                    zero(memR)), None
        YL_ctrl = torch.log1p(torch.clamp(Y[0], min=0.0))
        YR_ctrl = torch.log1p(torch.clamp(Y[1], min=0.0))
        feat = torch.cat([YL_ctrl, memL, YR_ctrl, memR], dim=-1)
        Qn, h, saved = controller_step(self.cfg, c, h, feat, drops,
                                       controller_params(self))
        beta = self.BETA
        memL = beta * memL + (1.0 - beta) * YL_ctrl.detach()
        memR = beta * memR + (1.0 - beta) * YR_ctrl.detach()
        return (Qn, h, memL, memR), (saved,)

    def y_cols(self) -> tuple:
        """The feature columns at which the step reads the ears' Y: the
        left's at 0 and the right's at 2N of [YL_ctrl, memL, YR_ctrl,
        memR]."""
        return (0, 2 * self.cfg.n_bands)


def auralnet_fb(cfg: BiEARConfig, wav: torch.Tensor, c: dict) -> torch.Tensor:
    """AuralNet's fixed filterbank: wav (B, Nsamp) -> band energies Y (B,
    T, N), the magnitude spectra times the clamped-Q0 matrix ``W_fixed``
    in f32 under either policy (TF32 off on the card), then nan_to_num.
    No phase (JAX ``auralnet_fb``)."""
    Xmag = spectra(cfg, wav, c, mag_only=True)[0]
    with precision_highest():
        Y = Xmag @ c["W_fixed"].T
    return torch.nan_to_num(Y, nan=0.0, posinf=0.0, neginf=0.0)


def make_frontend(cfg: BiEARConfig) -> _Frontend:
    """``SingleFrontend`` for controller_mode "single", else
    ``DualFrontend`` (the JAX package's dispatch)."""
    return (SingleFrontend if cfg.controller_mode == "single"
            else DualFrontend)(cfg)
