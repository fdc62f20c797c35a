"""The adaptive frontends' Q-controller: its parameters and its one step
from a frame's features to the next Q (JAX ``controller_step``,
``_next_q`` and ``_finite_reset`` in ``biear_tpu/models/frontend.py``).
The frame loop of ``models/frontend.py`` runs the step under autograd or
without, and ``models/frontend_bwd.py`` keeps its ``Saved`` tensors for
the hand backward; this module imports neither.

On the card, with gradients off and f32 products (``takes_kernel``), the
dual frontend runs both ears' steps of a frame as one launch of
``kernels/controller_fwd.cu`` (``dual_step_cuda``); ``controller_step``,
once an ear, is its plain twin and serves every other case.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import count_launch
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

# (rows of both ears, bands, hidden, GRU inputs) of every controller_fwd.cu
# launch made or captured in this process, counted (the benchmark's
# roofline reader takes the kernel's work from here)
LAUNCH_SHAPES: collections.Counter = collections.Counter()


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


def f32_products(x: torch.Tensor) -> bool:
    """Whether the policy's products are plain f32 for `x`: always on the
    CPU; on the card with TF32 off and no autocast."""
    if not x.is_cuda:
        return True
    return not (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32
                or torch.is_autocast_enabled("cuda"))


def takes_kernel(Y: torch.Tensor) -> bool:
    """Whether the dual frontend's step on band energies `Y` is one launch
    of ``controller_fwd.cu``: a CUDA tensor, gradients off and f32
    products. Under autograd, TF32 or autocast the composite ops stay."""
    return Y.is_cuda and not torch.is_grad_enabled() and f32_products(Y)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_tile(rows_per_ear: int, blocks_per_ear: int) -> int:
    """Rows of one ear a block of ``controller_fwd.cu`` or
    ``frontend_bwd.cu`` takes: the fewest of 1, 2, 4, 8 that keep an
    ear's blocks within `blocks_per_ear` (8 past that). Each launch is
    bound by the latency of its chain of products, so more resident warps
    beat fewer reads of the weights from L2 (the reverse recurrence at the
    flagship's 512 rows an ear: 4 rows a block, 39 us a frame; 8 rows, 50
    us)."""
    for rt in (1, 2, 4, 8):
        if -(-rows_per_ear // rt) <= blocks_per_ear:
            return rt
    return 8


def card_row_tile(rows_per_ear: int, dev: torch.device, per_sm: int,
                  ears: int = 2) -> int:
    """row_tile for the blocks of `ears` controllers (both ears', or the
    single frontend's one) at about `per_sm` a SM of the card that holds
    `dev`: two for ``frontend_bwd.cu``'s blocks of 256 threads, one for
    ``controller_fwd.cu``'s of 512."""
    sms = _sm_count(dev.index if dev.index is not None
                    else torch.cuda.current_device())
    return row_tile(rows_per_ear, sms * per_sm // ears)


def dual_step_cuda(cfg: BiEARConfig, c: dict, h: torch.Tensor,
                   Y: torch.Tensor, drops, ears):
    """Both ears' ``controller_step`` as one launch of
    ``controller_fwd.cu`` on the current stream: band energies Y (2, B,
    N), hidden state h (2, B, H), keep-masks drops (2 ears, 2 sites, B, H)
    or None, and each ear's 14 parameters (PARAM_NAMES' order) -> (Q' (2,
    B, N), h' (2, B, H), (left's Saved, right's)), each Saved field a
    contiguous view of an ear-stacked output. The features are [Y_ctrl,
    0.2 Y_ctrl] of Y_ctrl = log1p(max(Y, 0)), as the dual frontend makes
    them. A build or launch failure raises."""
    from ..kernels.build import check_launch, controller_fwd_lib

    B, N = Y.shape[1], Y.shape[2]
    H, n_in = cfg.ctrl_hidden, ears[0][0].shape[1]
    dev = Y.device
    h = h.contiguous()
    keeps = ([None] * 4 if drops is None else
             [drops[0, 0], drops[0, 1], drops[1, 0], drops[1, 1]])
    inputs = [Y, h, c["Q0"], c["deltaQ_vec"]]
    tensors = [x for ear in ears for x in ear] + inputs
    for x in tensors + [k for k in keeps if k is not None]:
        if not (x.is_cuda and x.device == dev and x.is_contiguous()):
            raise ValueError("controller_fwd needs contiguous tensors on one "
                             "CUDA device")
    if any(x.dtype != torch.float32 for x in tensors) or any(
            k is not None and k.dtype != torch.bool for k in keeps):
        raise ValueError("controller_fwd needs float32 tensors and bool "
                         "keep-masks")
    if (Y.shape[0] != 2 or tuple(h.shape) != (2, B, H) or n_in != 2 * N
            or (drops is not None and tuple(drops.shape) != (2, 2, B, H))):
        raise ValueError("controller_fwd: shapes do not fit the dual "
                         "frontend's step")
    widths = {"Q": N, "h": H, "feat": n_in, "ws": 5 * H, "hy": H, "a1": H,
              "l1": H, "mu1": 1, "rs1": 1, "d1": H, "a2": H, "l2": H,
              "mu2": 1, "rs2": 1, "d2": H, "delta": N, "qraw": N}
    out = {k: torch.empty((2, B, w), device=dev) for k, w in widths.items()}
    ok = torch.empty(2, dtype=torch.bool, device=dev)
    counters = torch.zeros(4, dtype=torch.int32, device=dev)
    ears_ptrs = [[x.data_ptr() for x in ear] for ear in ears]
    ptrs = (ears_ptrs[0] + [0 if k is None else k.data_ptr()
                            for k in keeps[:2]]
            + ears_ptrs[1] + [0 if k is None else k.data_ptr()
                              for k in keeps[2:]]
            + [x.data_ptr() for x in inputs]
            + [x.data_ptr() for x in out.values()]
            + [ok.data_ptr(), counters.data_ptr()])
    ints = [B, N, H, n_in, int(cfg.deltaQ_mode.lower() == "relative"),
            card_row_tile(B, dev, 1)]
    floats = [cfg.q_min, cfg.q_max, 1.0 - cfg.ctrl_dropout, LN_EPS]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = controller_fwd_lib().controller_fwd_launch(
            (ctypes.c_uint64 * len(ptrs))(*ptrs), len(ptrs),
            (ctypes.c_int * len(ints))(*ints), len(ints),
            (ctypes.c_float * len(floats))(*floats), len(floats), stream)
    check_launch(err, "controller_fwd")
    count_launch("controller_fwd")
    LAUNCH_SHAPES[(2 * B, N, H, n_in)] += 1
    saved = tuple(Saved(*(out[k][e] for k in Saved._fields[:-1]), ok[e])
                  for e in (0, 1))
    return out["Q"], out["h"], saved
