"""Plain reference of the single-controller adaptive-Q BiEAR model:
forward, loss and the trainer's gradients, in float32 PyTorch.

The paper's (arXiv 2606.06795) baseline arm, configured by
``conf/config_single_ctrl.yaml`` (``perfbench/configs/biear-single.json``):
one GRU Q-controller shared by both ears sets one Q a frame for both.
Every piece the dual reference has is taken from ``model.py`` by import
(constants, framing, spectra, the filterbank with its bfloat16 operands,
the band phase, the controller, the next Q, the encoders, the heads and
the input sanitising); this module adds the single controller's
parameters, its frame, its forward and the loss around it. It imports
nothing of the program under test.

One frame, from the carry (Q (B, N), h (B, H), memL, memR (B, N)):
  1. both ears filtered with the carried Q (one call on 2B rows, Q
     repeated, so Q's gradient sums both ears);
  2. Y_ctrl = log1p(max(Y, 0)) per ear;
  3. the controller (GRU 4N -> H, then [Linear, LayerNorm, SiLU,
     dropout] x2 and Linear -> tanh) on [YL_ctrl, memL, YR_ctrl, memR];
  4. the next Q from its output (absolute deltaQ: Q0 + dQ * delta, or
     relative: Q0 (1 + dQ * delta)), clamped to [q_min, q_max];
  5. a nonfinite Q anywhere in the batch resets Q to Q0 and h to zero
     for the whole batch;
  6. then the memories: mem = 0.8 mem + 0.2 Y_ctrl, Y_ctrl detached.

Departures from the paper's description, kept as its code has them:
  * the memories persist across frames (an EMA with beta 0.8, from zero),
    and are updated after the controller step, so frame t's controller
    reads the memory of frames before t;
  * the finite reset is decided over the whole batch, not per row.
The Q the regularisers see is the one each frame was filtered with
(frame 0's is Q0). The last frame's controller step runs here, though
nothing reads its carry.

Random draws: the controller's keep-masks of every frame in one draw of
shape (T, 2 sites, B, H), then the body's and each sector head's, as
``model.Drops`` draws them.
"""

from __future__ import annotations

import torch

from . import model as M
from . import train

BETA = 0.8


def param_specs(cfg: dict) -> list:
    """[(name, shape, bound)] of the single-controller model: the shared
    controller ``bifb.q_rnn`` (GRU inputs 4N) and ``bifb.q_out.{0,1,4,5,8}``,
    then the dual model's encoders, CC projection, body and heads."""
    N, H = cfg["n_bands"], cfg["ctrl_hidden"]
    dual = M.param_specs(dict(cfg, family="active"))
    return (M._controller("bifb", 4 * N, H, N)
            + [s for s in dual if not s[0].startswith("bifb.")])


def init_carry(cfg, c, B, device):
    z = lambda n: torch.zeros((B, n), device=device)
    return (c["Q0"].expand(B, cfg["n_bands"]), z(cfg["ctrl_hidden"]),
            z(cfg["n_bands"]), z(cfg["n_bands"]))


def single_frame(cfg, c, P, carry, XL, XR, drops=None):
    """One frame (steps 1-6 of the module's text): (carry', ((YL, Q,
    phaseL), (YR, Q, phaseR)))."""
    Q, h, memL, memR = carry
    B = Q.shape[0]
    Y, zre, zim = M.filterbank(cfg, c, torch.cat([Q, Q]),
                               tuple(torch.cat([a, b]) for a, b in zip(XL, XR)))
    phase = M.band_phase(zre, zim)
    out = ((Y[:B], Q, phase[:B]), (Y[B:], Q, phase[B:]))
    ycL = torch.log1p(torch.clamp(Y[:B], min=0.0))
    ycR = torch.log1p(torch.clamp(Y[B:], min=0.0))
    feat = torch.cat([ycL, memL, ycR, memR], -1)
    delta, h2 = M.controller(cfg, P, "bifb", h, feat, drops)
    Qn = M.next_q(cfg, c, delta)
    ok = torch.isfinite(Qn).all()
    Qn = torch.where(ok, Qn, c["Q0"].expand_as(Qn))
    h2 = torch.where(ok, h2, torch.zeros_like(h2))
    memL = BETA * memL + (1.0 - BETA) * ycL.detach()
    memR = BETA * memR + (1.0 - BETA) * ycR.detach()
    return (Qn, h2, memL, memR), out


def single_forward(cfg, c, P, wavL, wavR, x3, gen=None):
    """The single-controller model: (sound, aoa, dist, Q (B, T, N)). `gen`
    (training) draws the dropout masks."""
    B, T, H = wavL.shape[0], cfg["timesteps"], cfg["ctrl_hidden"]
    XL = M.spectra(cfg, c, M.frames_1s(cfg, c, wavL))
    XR = M.spectra(cfg, c, M.frames_1s(cfg, c, wavR))
    drop = M.Drops(gen)
    masks = drop.masks(cfg["ctrl_dropout"], (T, 2, B, H))
    carry = init_carry(cfg, c, B, wavL.device)
    YL, YR, Qs, pL, pR = ([] for _ in range(5))
    for t in range(T):
        carry, ((yl, q, phl), (yr, _, phr)) = single_frame(
            cfg, c, P, carry, tuple(x[:, t] for x in XL),
            tuple(x[:, t] for x in XR), None if masks is None else masks[t])
        for lst, v in zip((YL, YR, Qs, pL, pR), (yl, yr, q, phl, phr)):
            lst.append(v)
    st = lambda a: torch.stack(a, 1)
    x1, x2 = M.log_energy(st(YL)), M.log_energy(st(YR))
    z = [M.encoder(P, "encoder_ild", M.ild(x1, x2)),
         M.encoder(P, "encoder_ipd", M.ipd(st(pL), st(pR)))]
    s, a, d = M.heads(cfg, P, z, x3, drop)
    return s, a, d, st(Qs)


def loss(cfg, hp, c, P, batch, gen=None):
    """The weighted task loss and the Q regularisers, as ``model.loss``
    writes them, over ``single_forward``."""
    wavL, wavR, x3, y = batch
    wavL, wavR, x3 = M.sanitize(wavL, wavR, x3)
    s, a, d, Q = single_forward(cfg, c, P, wavL, wavR, x3, gen)
    y = y.reshape(y.shape[0], M.N_SECTORS, 2 + M.N_DIST)
    ys, ya, yd = y[..., 0], y[..., 1], y[..., 2:]
    sp = lambda x: torch.logaddexp(x, torch.zeros_like(x))
    l_s = (hp["pos_weight"] * ys * sp(-s) + (1.0 - ys) * sp(s)).mean()
    e = torch.abs(a - ya)
    l_a = torch.where(e < 0.02, 0.5 * e * e / 0.02, e - 0.01).mean()
    l_d = -torch.gather(torch.log_softmax(d, -1), -1,
                        torch.argmax(yd, -1)[..., None]).mean()
    lq = torch.log(Q + 1e-8)
    return (hp["loss_w_sound"] * l_s + hp["loss_w_aoa"] * l_a
            + hp["loss_w_dist"] * l_d
            + hp["reg_q_w"] * ((lq - torch.log(c["Q0"] + 1e-8)) ** 2).mean()
            + hp["reg_smooth_w"] * ((lq[..., 1:] - lq[..., :-1]) ** 2).mean())


class Trainer(train.Trainer):
    """``train.Trainer`` over the single-controller loss."""

    def grads(self, batch, gen):
        """(loss, {name: gradient}) of one training forward."""
        names = list(self.P)
        leaves = [self.P[n].requires_grad_(True) for n in names]
        with M.no_tf32():
            value = loss(self.cfg, self.hp, self.c, self.P, batch, gen)
            g = torch.autograd.grad(value, leaves, allow_unused=True)
        for n in names:
            self.P[n] = self.P[n].detach()
        return value.detach(), {n: torch.zeros_like(self.P[n]) if x is None
                                else x for n, x in zip(names, g)}
