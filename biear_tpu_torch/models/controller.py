"""The adaptive frontends' Q-controller: its parameters and its one step
from a frame's features to the next Q (JAX ``controller_step``,
``_next_q`` and ``_finite_reset`` in ``biear_tpu/models/frontend.py``).
The frame loop of ``models/frontend.py`` runs the step under autograd or
without, and ``models/frontend_bwd.py`` keeps its ``Saved`` tensors for
the hand backward; this module imports neither.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F
from torch import nn

from .config import BiEARConfig
from .layers import GRU, dropout_apply

# the saved tensors of one controller step, each (B, .) but ok ()
Saved = collections.namedtuple(
    "Saved", "feat ws hy a1 l1 mu1 rs1 d1 a2 l2 mu2 rs2 d2 delta qraw ok")

# a controller's parameters, in the order controller_step takes them
PARAM_NAMES = ("q_rnn.weight_ih_l0", "q_rnn.weight_hh_l0", "q_rnn.bias_ih_l0",
               "q_rnn.bias_hh_l0", "q_out.0.weight", "q_out.0.bias",
               "q_out.1.weight", "q_out.1.bias", "q_out.4.weight",
               "q_out.4.bias", "q_out.5.weight", "q_out.5.bias",
               "q_out.8.weight", "q_out.8.bias")

LN_EPS = 1e-5                     # the LayerNorms' eps, nn.LayerNorm's default


def make_q_out(cfg: BiEARConfig) -> nn.Sequential:
    """[Linear, LN, SiLU, Dropout] x2 and Linear(H -> N); indices 0, 1, 4,
    5, 8 are the reference's. Only their parameters are used (by
    ``controller_step``)."""
    H = cfg.ctrl_hidden
    return nn.Sequential(
        nn.Linear(H, H), nn.LayerNorm(H, eps=LN_EPS), nn.SiLU(),
        nn.Dropout(cfg.ctrl_dropout),
        nn.Linear(H, H), nn.LayerNorm(H, eps=LN_EPS), nn.SiLU(),
        nn.Dropout(cfg.ctrl_dropout),
        nn.Linear(H, cfg.n_bands))


class Controller(nn.Module):
    """The parameters of one Q-controller: GRU(n_in -> H) and
    ``make_q_out``, under the reference checkpoints' names."""

    def __init__(self, cfg: BiEARConfig, n_in: int):
        super().__init__()
        self.q_rnn = GRU(n_in, cfg.ctrl_hidden)
        self.q_out = make_q_out(cfg)


def controller_params(module: nn.Module) -> list:
    """`module`'s controller parameters in PARAM_NAMES' order."""
    return [module.get_parameter(n) for n in PARAM_NAMES]


def q_unclamped(cfg: BiEARConfig, c: dict,
                delta: torch.Tensor) -> torch.Tensor:
    """The next Q from the controller's delta, before the clamp."""
    if cfg.deltaQ_mode.lower() == "relative":
        return c["Q0"][None] * (1.0 + c["deltaQ_vec"][None] * delta)
    return c["Q0"][None] + c["deltaQ_vec"][None] * delta


def controller_step(cfg: BiEARConfig, c: dict, h: torch.Tensor,
                    feat: torch.Tensor, drops, params) -> tuple:
    """One controller update from the features feat (B, n_in) and the
    hidden state h (B, H): returns (Q', h', Saved).

    drops: the keep-masks (2, B, H) of the two dropout sites, or None for
    none. params: the controller's 14 parameters in PARAM_NAMES' order.
    The GRU cell is torch.gru_cell's ops with its workspace ws (B, 5H) =
    [r, z, n, h, W_hn h + b_hn]: on the card the two products and the
    fused cell, on the CPU the composite formula. Q' is the next Q,
    clamped to [q_min, q_max]; a nonfinite Q' anywhere in the batch resets
    Q' to Q0 and h' to zeros for the whole batch, decided on the device
    (no .item()). Every ``Saved`` field is the contiguous output of its op,
    as ``frontend_bwd.frame_bwd_cuda`` reads it."""
    w_ih, w_hh, b_ih, b_hh, w0, b0, g1, be1, w4, b4, g5, be5, w8, b8 = params
    H = w0.shape[0]
    rate = cfg.ctrl_dropout
    if feat.is_cuda:
        hy, ws = torch.ops.aten._thnn_fused_gru_cell(
            feat.matmul(w_ih.t()), h.matmul(w_hh.t()), h, b_ih, b_hh)
    else:
        ir, iz, inn = F.linear(feat, w_ih, b_ih).chunk(3, 1)
        hr, hz, hn = F.linear(h, w_hh, b_hh).chunk(3, 1)
        r = torch.sigmoid(hr + ir)
        z = torch.sigmoid(hz + iz)
        n = torch.tanh(inn + hn * r)
        hy, ws = (h - n) * z + n, torch.cat([r, z, n, h, hn], 1)
    a1 = F.linear(hy, w0, b0)
    l1, mu1, rs1 = torch.native_layer_norm(a1, [H], g1, be1, LN_EPS)
    d1 = F.silu(l1)
    if drops is not None:
        d1 = dropout_apply(drops[0], d1, rate)
    a2 = F.linear(d1, w4, b4)
    l2, mu2, rs2 = torch.native_layer_norm(a2, [H], g5, be5, LN_EPS)
    d2 = F.silu(l2)
    if drops is not None:
        d2 = dropout_apply(drops[1], d2, rate)
    delta = torch.tanh(F.linear(d2, w8, b8))
    qraw = q_unclamped(cfg, c, delta)
    Qc = torch.clamp(qraw, cfg.q_min, cfg.q_max)
    ok = torch.isfinite(Qc).all()
    saved = Saved(feat, ws, hy, a1, l1, mu1, rs1, d1, a2, l2, mu2, rs2, d2,
                  delta, qraw, ok)
    return (torch.where(ok, Qc, c["Q0"][None].expand_as(Qc)),
            torch.where(ok, hy, torch.zeros_like(hy)), saved)
