"""The adaptive frontends' frame loop as one autograd Function whose
backward runs the reverse recurrence explicitly, one launch a frame.

Counterpart of the JAX package's training path through
``biear_tpu/models/frontend.py``: a ``lax.scan`` over ``adaptive_step``
(dual) or ``single_step`` (single) whose body and reverse pass XLA fuses
(no Pallas kernel exists for it). Under autograd, the port's
``frame_loop`` records some 200 small ops a frame; here the whole loop is
one node.

``_Frontend.hand_backward`` picks it for the production policy only
(``controller.f32_products`` is part of that choice); every other
combination runs ``frame_loop`` under autograd. One Function serves both
frontends; what differs follows the frontend's structure
(``controllers()``, and the feature columns at which each controller
reads the ears' Y, ``y_cols()``): the dual frontend has two controllers,
each reading its own ear's Y at feature columns 0:N; the single frontend
one, reading the left ear's at 0:N and the right's at 2N:3N, whose Q the
(2B) filterbank call repeats for both ears, so the Q carry's gradient
sums over them.

Forward (``RecurrenceFn.forward``, gradients off): the frontend's own
``frame_loop``, with a filterbank that calls ``gauss_contract`` with T and
keeps each frame's set, and a sink that keeps each frame's ``controller.
Saved`` of every controller (``controller_step``): the GRU cell's
workspace (r, z, n, h and W_hn h + b_hn), each LayerNorm's input, output,
mean and 1/std, the dropout outputs, tanh's output, Q before the clamp and
the finite reset's flag. The loop runs no controller step at the last
frame: its carry feeds nothing. Nothing of size (2B, N, F) is kept.

Backward: for t = T-1 .. 0, ``frame_bwd`` takes the gradients of Q(t+1)
and h(t+1) back through frame t's controller step (finite reset, clamp,
next Q, tanh, Linear 8, dropout, SiLU, LayerNorm 5, Linear 4, dropout,
SiLU, LayerNorm 1, Linear 0, GRU cell), adds the controller's gradient of
each ear's Y(t), through log1p and clamp, to the backend's, runs the band
phase's and the "bf16|noxg" filterbank's VJP to dQ(t) and adds the Q
output's own gradient: the carry of frame t-1 (the single frontend's,
dQ_L + dQ_R + gQ_L + gQ_R). The EMA memories, built from detached Y,
carry none. It writes each row's activation gradients (``GROW``), and
after the loop the weight and bias gradients of every controller over all
(T-1) B rows are five batched f32 products and sums. Frame 0's Q is the
constant Q0 and h(0) is zero, so frame 0 stops at the controller's
activation gradients. ``frame_bwd`` is one launch of
``kernels/frontend_bwd.cu`` for CUDA tensors (its dual entry, a block on
rows of one ear, or its single entry, a block on rows of the shared
controller, each feeding two filterbank rows) and ``frame_bwd_plain``
(the same steps in PyTorch ops) for CPU tensors.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ..device import precision_highest
from ..kernels import count_launch
from ..ops import filterbank
from ..ops.filterbank import EPS_Q
from .controller import Saved, card_row_tile

# (controller rows a frame, bands, hidden, GRU inputs, with_ctrl,
# with_input) of every frontend_bwd.cu launch made or captured in this
# process, counted (the benchmark's roofline readers take the kernel's
# work from here): with_ctrl, the controller step's backward ran (every
# frame but the last); with_input, the gradients into h(t) and Y(t) and
# the filterbank's VJP ran (every frame but the first). LAUNCH_SHAPES
# holds the dual entry's (both ears' 2B rows), SINGLE_LAUNCH_SHAPES the
# single entry's (B rows, each with two filterbank rows).
LAUNCH_SHAPES: collections.Counter = collections.Counter()
SINGLE_LAUNCH_SHAPES: collections.Counter = collections.Counter()


def grow_layout(H: int, N: int) -> dict:
    """Column offsets of a row of activation gradients (``GROW``): the GRU
    input gates' [r, z, n] and hidden gates' [r, z, r * n] pre-activation
    gradients (3H each), then Linear 0's output gradient, LayerNorm 1's
    output gradient and that times x_hat (H each), the same three for
    Linear 4 and LayerNorm 5, and Linear 8's output gradient (N)."""
    off = {}
    at = 0
    for name, width in (("gi", 3 * H), ("gh", 3 * H), ("a1", H), ("l1", H),
                        ("lx1", H), ("a2", H), ("l2", H), ("lx2", H),
                        ("a3", N)):
        off[name] = (at, at + width)
        at += width
    off["width"] = at
    return off


class RecurrenceFn(torch.autograd.Function):
    """apply(front, c, rhs, masks, *params) -> (Y, Q, phase), each (2, B,
    T, N), as ``_Frontend.frame_loop`` stacks them; params are each of
    ``front.controllers()``' 14 in ``controller.PARAM_NAMES``' order (the
    dual frontend's fb_L then fb_R), the tensors ``front``'s loop reads.
    rhs gets no gradient ("|noxg"): a zero one if it requires one."""

    @staticmethod
    def forward(ctx, front, c, rhs, masks, *params):
        fc, f_fft = c["fc"], c["f_fft"]
        fbs, ctrls = [], []

        def fb(Q, x):
            Y, Zre, Zim, den, finite, bw, Tm = filterbank.gauss_contract(
                Q, x, fc, f_fft, True)
            fbs.append((Q, bw, Tm, Y, Zre, Zim, den, finite))
            return Y, Zre, Zim
        outs = front.frame_loop(c, rhs, masks, fb, ctrls)
        ctx.save_for_backward(*params)
        ctx.front, ctx.c, ctx.masks = front, c, masks
        ctx.fbs, ctx.ctrls = fbs, ctrls
        ctx.rhs_meta = (rhs.shape, rhs.dtype, rhs.device)
        return outs

    @staticmethod
    def backward(ctx, gY, gQ, gP):
        params = ctx.saved_tensors
        front, c = ctx.front, ctx.c
        T = len(ctx.fbs)
        st = Statics(front.cfg, c, params, gY.shape[1], T, front.y_cols())
        E = len(st.weights)
        gY, gQ, gP = (g.contiguous() for g in (gY, gQ, gP))
        grow = torch.empty((E, max(T - 1, 0), st.B,
                            grow_layout(st.H, st.N)["width"]),
                           device=gY.device)
        carry = (None, None)
        for t in range(T - 1, -1, -1):
            ctrl = ctx.ctrls[t] if t < T - 1 else None
            fbs = ctx.fbs[t] if t > 0 else None
            keep = (None if ctx.masks is None or ctrl is None
                    else ctx.masks[t].reshape(E, 2, st.B, st.H))
            carry = frame_bwd(st, t, ctrl, keep, fbs, gY, gQ, gP, carry,
                              grow)
        grads = weight_grads(st, grow, ctx.ctrls, params)
        g_rhs = None
        if ctx.needs_input_grad[2]:
            shape, dtype, device = ctx.rhs_meta
            g_rhs = torch.zeros(shape, dtype=dtype, device=device)
        return (None, None, g_rhs, None, *grads)


class Statics:
    """What every frame of the backward shares: the shapes, the policy's
    numbers, the constants, each controller's parameters (``weights``)
    and the feature columns at which a controller reads each ear's Y
    (``y_cols``, the frontend's ``y_cols()``: (0,) dual, (0, 2N)
    single)."""

    def __init__(self, cfg, c, params, B, T, y_cols):
        self.B, self.T = B, T
        self.N, self.H = cfg.n_bands, cfg.ctrl_hidden
        self.relative = cfg.deltaQ_mode.lower() == "relative"
        self.q_min, self.q_max = cfg.q_min, cfg.q_max
        self.rate = cfg.ctrl_dropout
        self.fc, self.Q0, self.dqv = c["fc"], c["Q0"], c["deltaQ_vec"]
        self.weights = tuple(params[i:i + 14]
                             for i in range(0, len(params), 14))
        self.y_cols = tuple(y_cols)


def frame_bwd(st, t, ctrl, keep, fbs, gY, gQ, gP, carry, grow):
    """Frame t of the reverse recurrence (module docstring), over E = 2
    controllers (dual) or 1 (single): ctrl, each controller's ``Saved`` of
    frame t's step, or None at the last frame; keep, frame t's keep-masks
    (E, 2, B, H) or None; fbs, frame t's filterbank set (Q, bw, T, Y, Zre,
    Zim, den, finite) over both ears' 2B rows, or None at frame 0; gY, gQ,
    gP the outputs' gradients (2, B, T, N); carry, the gradients of Q(t+1)
    (E, B, N) and h(t+1) (E, B, H), each None where nothing flows; frame
    t's rows of grow (E, T-1, B, width) are written. Returns the carry of
    frame t-1: (gradient of Q(t), of h(t))."""
    if gY.is_cuda:
        return frame_bwd_cuda(st, t, ctrl, keep, fbs, gY, gQ, gP, carry,
                              grow)
    with precision_highest():
        return frame_bwd_plain(st, t, ctrl, keep, fbs, gY, gQ, gP, carry,
                               grow)


def _act_bwd(g, keep, rate, l):
    """Through dropout (keep-mask or None) and SiLU of its input l."""
    if keep is not None:
        g = torch.where(keep, g / (1.0 - rate), 0.0)
    s = torch.sigmoid(l)
    return g * s * (1.0 + l * (1.0 - s))


def _ln_bwd(gl, a, mu, rs, gamma):
    """LayerNorm's input gradient from its output gradient: (ga, x_hat)."""
    xh = (a - mu) * rs
    gx = gl * gamma
    H = a.shape[-1]
    s1 = gx.sum(-1, keepdim=True)
    s2 = (gx * xh).sum(-1, keepdim=True)
    return (rs / H) * (H * gx - xh * s2 - s1), xh


def _phase_vjp(g, Zre, Zim, eps_mag: float = 1e-3):
    """band_phase's VJP, the steps autograd takes: (gZre, gZim)."""
    s = torch.sqrt(Zre * Zre + Zim * Zim)
    mag = torch.clamp(s, min=eps_mag)
    u, v = Zim / mag, Zre / mag
    recip = (u * u + v * v).reciprocal()
    gu, gv = g * v * recip, g * -u * recip
    gmag = -gu * Zim / (mag * mag) + -gv * Zre / (mag * mag)
    gss = torch.where(s >= eps_mag, gmag, 0.0) / (2.0 * s)
    return gv / mag + 2.0 * (gss * Zre), gu / mag + 2.0 * (gss * Zim)


def _stack(saved, name):
    return torch.stack([getattr(s, name) for s in saved])


def frame_bwd_plain(st, t, ctrl, keep, fbs, gY, gQ, gP, carry, grow):
    """frame_bwd in PyTorch ops, the controllers as a leading axis (2
    dual, 1 single), both ears' filterbank rows as one of 2."""
    B, N, H = st.B, st.N, st.H
    gq_in, gh_in = carry
    gyc = gh_prev = None
    if ctrl is not None:
        S = {k: _stack(ctrl, k) for k in Saved._fields}
        W = [torch.stack([p[i] for p in st.weights]) for i in range(14)]
        ok = S["ok"][:, None, None]
        gq = torch.where(ok, gq_in, 0.0)
        gq = torch.where((S["qraw"] >= st.q_min) & (S["qraw"] <= st.q_max),
                         gq, 0.0)
        gdelta = (gq * st.Q0 * st.dqv if st.relative else gq * st.dqv)
        ga3 = gdelta * (1.0 - S["delta"] * S["delta"])
        k0, k1 = (None, None) if keep is None else (keep[:, 0], keep[:, 1])
        gl2 = _act_bwd(torch.bmm(ga3, W[12]), k1, st.rate, S["l2"])
        ga2, xh2 = _ln_bwd(gl2, S["a2"], S["mu2"], S["rs2"], W[10][:, None])
        gl1 = _act_bwd(torch.bmm(ga2, W[8]), k0, st.rate, S["l1"])
        ga1, xh1 = _ln_bwd(gl1, S["a1"], S["mu1"], S["rs1"], W[6][:, None])
        ghy = torch.bmm(ga1, W[4])
        if gh_in is not None:
            ghy = ghy + torch.where(ok, gh_in, 0.0)
        r, z, n, hx, hn = S["ws"].split(H, -1)
        gig = ghy * (hx - n) * (1 - z) * z
        ghx = ghy * z
        gin = ghy * (1 - z) * (1 - n * n)
        ghn = gin * r
        grg = gin * hn * (1 - r) * r
        grow[:, t] = torch.cat([grg, gig, gin, grg, gig, ghn, ga1, gl1,
                                gl1 * xh1, ga2, gl2, gl2 * xh2, ga3], -1)
        if t > 0:
            gh_prev = ghx + torch.bmm(torch.cat([grg, gig, ghn], -1), W[1])
            gates = torch.cat([grg, gig, gin], -1)
            gyc = torch.cat([torch.bmm(gates, W[0][:, :, lo:lo + N])
                             for lo in st.y_cols])
    if fbs is None:
        return None, None
    Q, bw, Tm, Y, Zre, Zim, den, finite = (
        x.reshape(2, B, *x.shape[1:]) for x in fbs)
    gy = gY[:, :, t]
    if gyc is not None:
        gy = gy + torch.where(Y >= 0, gyc / (torch.clamp(Y, min=0.0) + 1.0),
                              0.0)
    gzre, gzim = _phase_vjp(gP[:, :, t], Zre, Zim)
    gy = torch.where(finite, gy, 0.0)
    gden = -(gy * Y + gzre * Zre + gzim * Zim) / den
    g4 = torch.stack([gy / den, gzre / den, gzim / den, gden], dim=-1)
    dQ = -st.fc / torch.square(Q + EPS_Q) / bw * torch.sum(g4 * Tm, -1)
    if len(st.weights) == 2:
        return dQ + gQ[:, :, t], gh_prev
    # one Q for both ears: the (2B) call's and the output's gradients sum
    return (dQ[0] + dQ[1] + gQ[0, :, t] + gQ[1, :, t])[None], gh_prev


def weight_grads(st, grow, ctrls, params) -> list:
    """Every controller's parameter gradients, in the Function's order,
    from the rows of activation gradients and the saved activations
    (``feat`` with the memories, where the controller reads them): per
    weight one f32 product batched over controllers and frames, then
    summed over the frames (one product per controller over all (T-1) B
    rows would give the card two output tiles' worth of blocks, each
    summing 9,728 rows at the flagship's batch); every bias and LayerNorm
    parameter from one sum over all rows."""
    if not ctrls:
        return [torch.zeros_like(p) for p in params]
    N, H = st.N, st.H
    lay = grow_layout(H, N)
    frames, E = len(ctrls), len(st.weights)
    G = grow.view(E * frames, st.B, lay["width"])
    X = {k: torch.stack([getattr(s[e], k) for e in range(E) for s in ctrls])
         for k in ("feat", "ws", "hy", "d1", "d2")}
    with precision_highest():
        def mm(name, x):
            lo, hi = lay[name]
            prod = torch.bmm(G[..., lo:hi].transpose(1, 2), x)
            return prod.view(E, frames, *prod.shape[1:]).sum(1)
        w_ih = mm("gi", X["feat"])
        w_hh = mm("gh", X["ws"][..., 3 * H:4 * H])
        w0, w4, w8 = mm("a1", X["hy"]), mm("a2", X["d1"]), mm("a3", X["d2"])
    S = G.view(E, frames * st.B, -1).sum(1)
    col = lambda e, name: S[e, lay[name][0]:lay[name][1]]
    out = []
    for e in range(E):
        out += [w_ih[e], w_hh[e], col(e, "gi"), col(e, "gh"), w0[e],
                col(e, "a1"), col(e, "lx1"), col(e, "l1"), w4[e],
                col(e, "a2"), col(e, "lx2"), col(e, "l2"), w8[e],
                col(e, "a3")]
    return out


# ---------------------------------------------------------------- the card

def _ptr(x) -> int:
    return 0 if x is None else x.data_ptr()


def frame_bwd_cuda(st, t, ctrl, keep, fbs, gY, gQ, gP, carry, grow):
    """frame_bwd as one launch of ``frontend_bwd.cu`` on the current
    stream: its dual entry for two controllers (a block on rows of one
    ear), its single entry ``single_bwd`` for one (a block on rows of the
    shared controller, each with both ears' filterbank rows). Every saved
    tensor is the contiguous output of the forward's op; weights are the
    parameters, contiguous. A build or launch failure raises."""
    from ..kernels.build import check_launch, frontend_bwd_lib

    B, N, H = st.B, st.N, st.H
    T = st.T
    E = len(st.weights)
    dev = gY.device
    gq_in, gh_in = carry
    with_ctrl, with_input = ctrl is not None, fbs is not None
    ears = []
    for e in range(E):
        p = st.weights[e]
        w = [p[0], p[1], p[4], p[8], p[12], p[6], p[10]]
        s = ctrl[e] if with_ctrl else None
        sv = ([s.ws, s.a1, s.l1, s.mu1, s.rs1, s.a2, s.l2, s.mu2, s.rs2,
               s.delta, s.qraw, s.ok] if with_ctrl else [None] * 12)
        k = ([keep[e, 0], keep[e, 1]] if with_ctrl and keep is not None
             else [None, None])
        ears.append(w + sv + k)
    fb = list(fbs) if with_input else [None] * 8
    tensors = [x for ear in ears for x in ear] + fb + [gY, gQ, gP]
    name = "frontend_bwd" if E == 2 else "single_bwd"
    for x in tensors:
        if x is not None and not (x.is_cuda and x.device == dev
                                  and x.is_contiguous()):
            raise ValueError(f"{name} needs contiguous tensors on one CUDA "
                             "device")
    if grow.dtype != torch.float32 or not grow.is_contiguous():
        raise ValueError(f"{name} needs a contiguous float32 grow")
    if st.y_cols[0] != 0 or len(st.y_cols) != 3 - E:
        raise ValueError(f"{name} reads the left (or its own) ear's Y at "
                         f"feature column 0, not {st.y_cols}")
    gq_out = torch.empty((E, B, N), device=dev) if with_input else None
    gh_out = (torch.empty((E, B, H), device=dev)
              if with_input and with_ctrl else None)
    ptrs = [_ptr(x) for x in tensors] + [
        _ptr(gq_in), _ptr(gh_in), _ptr(gq_out), _ptr(gh_out), _ptr(grow),
        _ptr(st.fc), _ptr(st.Q0), _ptr(st.dqv)]
    n_in = st.weights[0][0].shape[1]
    ints = [B, N, H, n_in, t, T, int(with_ctrl), int(with_input),
            int(st.relative), card_row_tile(B, dev, 2, E), st.y_cols[-1]]
    floats = [st.q_min, st.q_max, 1.0 - st.rate]
    lib = frontend_bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{name}_launch")(
            (ctypes.c_uint64 * len(ptrs))(*ptrs), len(ptrs),
            (ctypes.c_int * len(ints))(*ints), len(ints),
            (ctypes.c_float * len(floats))(*floats), len(floats), stream)
    check_launch(err, name)
    count_launch(name)
    shapes = LAUNCH_SHAPES if E == 2 else SINGLE_LAUNCH_SHAPES
    shapes[(E * B, N, H, n_in, with_ctrl, with_input)] += 1
    return gq_out, gh_out
