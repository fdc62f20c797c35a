"""The dual frontend's reverse recurrence (``models/frontend_bwd.py``).

On the CPU the Function's plain backward is held against autograd through
the loop of ``DualFrontend.frame`` (``frame_loop``) on the same weights,
spectra and dropout masks: the outputs bit for bit, every controller
parameter's gradient (and a spectra gradient of zero) to float32 rounding.
Cases: both ears with dropout, an odd batch, a frame where the finite
reset fires in one ear, Q pinned at q_min and at q_max, rows whose Y is
nonfinite (the finite mask), a Q-regulariser loss on the Q output, the
absolute next-Q rule. The routing: only the bf16|noxg policy with the
custom VJP, f32 products and autograd takes the Function (the single
frontend's cases: ``test_torch_port_single_bwd.py``); everything else
keeps the loop.

The tests marked ``cuda`` hold ``kernels/frontend_bwd.cu`` against the
plain backward on the card, frame by frame, at the flagship's frame (1,024
rows), the spirit cell's (128) and a ragged one, replayed in a CUDA graph
and inside the captured train chunk (19 launches a step). This file
imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_frontend_bwd.py
"""

import copy

import pytest
import torch

from biear_tpu_torch.device import precision_highest
from biear_tpu_torch.kernels import LAUNCHES
from biear_tpu_torch.kernels import build
from biear_tpu_torch.models import BiEARConfig
from biear_tpu_torch.models import controller as tctrl
from biear_tpu_torch.models import frontend as tfe
from biear_tpu_torch.models import frontend_bwd as fbw
from biear_tpu_torch.models.layers import dropout_masks, init_module_
from biear_tpu_torch.ops.filterbank import stack_rhs
from biear_tpu_torch.train.losses import q_regularizers

SMALL = dict(fs=1600, timesteps=4, n_fft=64, n_bands=9, fmin=50.0,
             fmax=700.0, latent_dim=8, ctrl_hidden=8, deltaQ_mode="relative",
             deltaQ_base=1.0, deltaQ_low_factor=0.3, deltaQ_high_factor=5.0,
             fb_w_dtype="bfloat16")
# the flagship's widths (conf/config.yaml), for the card
FLAGSHIP = dict(SMALL, fs=16000, timesteps=19, n_fft=1024, n_bands=100,
                fmax=None, latent_dim=100, ctrl_hidden=128)


def _case(B=3, seed=0, device="cpu", dropout=True, **kw):
    """(front, c, rhs (T, 2B, 4, F) bf16, masks or None): a DualFrontend
    with seeded weights (the output layer off zero, so Q moves), spectra
    of random waveforms, keep-masks from a generator."""
    cfg = BiEARConfig(**{**SMALL, **kw})
    front = tfe.DualFrontend(cfg)
    gen = torch.Generator().manual_seed(seed)
    init_module_(front, gen)
    with torch.no_grad():
        for ctrl in front.controllers():
            for p in ctrl.q_out[8].parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    front = front.to(device)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    wav = torch.rand((2, B, cfg.fs), generator=g, device=device) * 2 - 1
    c = tfe.device_constants(cfg, device)
    sL, sR = (tfe.spectra(cfg, w, c) for w in wav)
    rhs = torch.cat([stack_rhs(*sL, True),
                     stack_rhs(*sR, True)]).transpose(0, 1)
    masks = (dropout_masks(g, cfg.ctrl_dropout,
                           (cfg.timesteps, 2, 2, B, cfg.ctrl_hidden))
             if dropout else None)
    return front, c, rhs, masks


def _params(front):
    return [p for ctrl in (front.fb_L, front.fb_R)
            for p in tctrl.controller_params(ctrl)]


def _grads(front, outs, loss_fn, extra=()):
    loss = loss_fn(*outs)
    return torch.autograd.grad(loss, _params(front) + list(extra))


def _cot_loss(seed, shape_of):
    gen = torch.Generator().manual_seed(seed)
    cots = [torch.randn(o.shape, generator=gen).to(o.device)
            for o in shape_of]
    return lambda *outs: sum((torch.nan_to_num(o) * w).sum()
                             for o, w in zip(outs, cots))


def _close(got, want):
    for a, b in zip(got, want):
        scale = float(torch.nan_to_num(b).abs().max()) or 1.0
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * scale,
                                   equal_nan=True)


def _compare(front, c, rhs, masks, loss_fn=None, rhs_grad=False):
    """Outputs and gradients of the Function and of the loop: one shared
    forward (``frame_loop``), held to the same bits with and without the
    Function, and the hand backward against autograd through it. Returns
    the Function's outputs and gradients."""
    extra = []
    if rhs_grad:
        rhs = rhs.detach().float().requires_grad_()
        extra = [rhs]
    new = front.recurrence(c, rhs.to(torch.bfloat16) if rhs_grad
                           else rhs, masks)
    old = front.frame_loop(c, rhs.to(torch.bfloat16) if rhs_grad else rhs,
                           masks)
    for a, b in zip(new, old):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    loss_fn = loss_fn or _cot_loss(7, old)
    grads = _grads(front, new, loss_fn, extra)
    _close(grads, _grads(front, old, loss_fn, extra))
    return new, grads


@pytest.mark.parametrize("B,dropout", [(3, True), (2, False), (1, True)])
def test_plain_backward_matches_autograd_through_the_loop(B, dropout):
    front, c, rhs, masks = _case(B, seed=B, dropout=dropout)
    _compare(front, c, rhs, masks)


def test_absolute_next_q_matches_autograd():
    front, c, rhs, masks = _case(3, seed=4, deltaQ_mode="absolute",
                                 deltaQ_base=2.0, deltaQ_low_factor=0.5,
                                 deltaQ_high_factor=1.0)
    _compare(front, c, rhs, masks)


def test_q_pinned_at_both_clamp_ends_matches_autograd():
    """q_min and q_max inside Q0's range: bands sit at each end of the
    clamp, where no gradient passes."""
    front, c, rhs, masks = _case(3, seed=5, q_min=2.0, q_max=4.0)
    Q = _compare(front, c, rhs, masks)[0][1]
    assert bool((Q == 2.0).any()) and bool((Q == 4.0).any())
    assert bool(((Q > 2.0) & (Q < 4.0)).any())


def test_finite_reset_in_one_ear_matches_autograd(monkeypatch):
    """A NaN in the right ear's next Q at frame 1 resets that ear (Q to
    Q0, h to zero) there and only there; the left ear runs on."""
    front, c, rhs, masks = _case(3, seed=6, timesteps=5)
    real = tctrl.q_unclamped
    calls = []

    def poisoned(cfg, c, delta):
        q = real(cfg, c, delta)
        calls.append(1)
        if len(calls) == 4:                # frame 1, right ear
            q = q.clone()
            q[1, 2] = float("nan")
        return q
    monkeypatch.setattr(tctrl, "q_unclamped", poisoned)

    def run(fn):
        calls.clear()
        return fn(front, c, rhs, masks)
    new = run(tfe.DualFrontend.recurrence)
    old = run(tfe.DualFrontend.frame_loop)
    for a, b in zip(new, old):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    Q = new[1]
    assert torch.equal(Q[1, :, 2], c["Q0"].expand(3, -1))
    assert not torch.equal(Q[0, :, 2], c["Q0"].expand(3, -1))
    loss_fn = _cot_loss(8, old)
    got = _grads(front, run(tfe.DualFrontend.recurrence), loss_fn)
    want = _grads(front, run(tfe.DualFrontend.frame_loop), loss_fn)
    _close(got, want)
    assert all(bool(torch.isfinite(g).all()) for g in got)


def test_nonfinite_y_rows_match_autograd():
    """Spectra near the bf16 maximum overflow some bands' Y sums: those Y
    are zeroed (finite mask False) and take no gradient, in both paths."""
    front, c, rhs, masks = _case(3, seed=9)
    rhs = rhs.clone()
    rhs[1:3, 1, 0, 20:27] = 3.0e38
    outs, grads = _compare(front, c, rhs, masks)
    assert bool((outs[0][0, 1, 1:3] == 0).any())
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_q_regulariser_loss_and_spectra_gradient():
    """The training loss's Q regularisers on the Q output, plus the Y and
    phase outputs; spectra that require a gradient get zeros (no spectra
    gradient under bf16|noxg), as from the loop."""
    front, c, rhs, masks = _case(3, seed=10)
    Q0 = c["Q0"]

    def loss(Y, Q, P):
        return (q_regularizers(0.5 * (Q[0] + Q[1]), Q0, 1e-3, 1e-3)
                + 0.1 * (torch.log(Y + 1e-8)).mean() + P.square().mean())
    _compare(front, c, rhs, masks, loss, rhs_grad=True)


def test_plain_frames_write_every_activation_gradient_row(monkeypatch):
    """grow (2, T-1, B, 12 H + N) is written in full by the frames of the
    backward (here its allocation is filled with NaN first), and its
    layout is grow_layout's."""
    lay = fbw.grow_layout(8, 9)
    assert lay["width"] == 12 * 8 + 9 and lay["a3"] == (96, 105)
    assert lay["gi"] == (0, 24) and lay["gh"] == (24, 48)
    front, c, rhs, masks = _case(2, seed=11)
    seen = []
    real_grads, real_empty = fbw.weight_grads, torch.empty

    def spy(st, grow, ctrls, params):
        seen.append(grow.clone())
        return real_grads(st, grow, ctrls, params)
    monkeypatch.setattr(fbw, "weight_grads", spy)
    monkeypatch.setattr(torch, "empty", lambda *a, **k: real_empty(
        *a, **k).fill_(float("nan")))
    outs = front.recurrence(c, rhs, masks)
    torch.autograd.grad(sum(o.sum() for o in outs), _params(front))
    assert seen[0].shape == (2, 3, 2, lay["width"])
    assert bool(torch.isfinite(seen[0]).all())


@pytest.mark.parametrize("change,takes", [
    ({}, True), ({"controller_mode": "single"}, True),
    ({"fb_w_dtype": "float32"}, False), ({"fb_x_grad": True}, False),
    ({"fb_vjp": "autodiff"}, False), ({"freeze_q": True}, False),
    ({"fixed_frontend_q": True}, False)],
    ids=["dual-bf16-noxg", "single", "f32", "x-grad", "autodiff",
         "freeze-q", "fixed-q"])
def test_only_the_dual_bf16_noxg_custom_frontend_takes_the_function(
        monkeypatch, change, takes):
    """The bf16|noxg custom policy under autograd takes the Function, in
    the dual frontend and (since it has a recurrence of its own) in the
    single one; every other policy keeps the loop."""
    from biear_tpu_torch.models import build_active

    calls = []
    real = tfe._Frontend.recurrence
    monkeypatch.setattr(tfe._Frontend, "recurrence",
                        lambda *a: calls.append(1) or real(*a))
    cfg = BiEARConfig(**{**SMALL, **change})
    model = build_active(cfg, seed=1, device="cpu").train()
    wav = torch.rand((2, 2, cfg.fs)) * 2 - 1
    gen = torch.Generator().manual_seed(0)
    out = model.bifb(wav[0], wav[1], gen, True)
    assert calls == ([1] if takes else [])
    if takes:
        torch.autograd.grad(out[2].sum() + out[0].sum(),
                            list(model.bifb.parameters()))
    # never without autograd, nor with no parameter to train
    calls.clear()
    with torch.no_grad():
        model.bifb(wav[0], wav[1], gen, True)
    for p in model.parameters():
        p.requires_grad_(False)
    model.bifb(wav[0], wav[1], gen, True)
    assert calls == []


def test_the_cuda_entry_refuses_cpu_tensors_before_the_library(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "frontend_bwd_lib",
                        lambda: calls.append(1) or None)
    front, c, rhs, masks = _case(2, seed=12)
    LAUNCHES.clear()
    fbw.LAUNCH_SHAPES.clear()
    outs = front.recurrence(c, rhs, masks)
    torch.autograd.grad(sum(o.sum() for o in outs), _params(front))
    assert calls == [] and LAUNCHES["frontend_bwd"] == 0
    assert not fbw.LAUNCH_SHAPES
    ctx = _Ctx()
    with torch.no_grad():
        fbw.RecurrenceFn.forward(ctx, front, c, rhs, masks,
                                 *_params(front))
    st = fbw.Statics(front.cfg, c, ctx.saved_tensors, 2, 4,
                     front.y_cols())
    g = torch.zeros((2, 2, 4, 9))
    grow = torch.empty((2, 3, 2, fbw.grow_layout(8, 9)["width"]))
    with pytest.raises(ValueError, match="CUDA"):
        fbw.frame_bwd_cuda(st, 2, ctx.ctrls[2], masks[2], ctx.fbs[2], g, g,
                           g, (torch.zeros(2, 2, 9), None), grow)
    assert calls == []


def test_row_tile_makes_about_two_blocks_a_sm():
    assert tctrl.row_tile(512, 132) == 4     # the flagship: 256 blocks
    assert tctrl.row_tile(64, 132) == 1      # the spirit cell: 128 blocks
    assert tctrl.row_tile(200, 132) == 2
    assert tctrl.row_tile(5000, 132) == 8


# ---------------------------------------------------------------- the card

class _Ctx:
    """A stand-in for autograd's ctx, to run the Function's forward and
    backward by hand."""
    needs_input_grad = (False,) * 40

    def save_for_backward(self, *t):
        self.saved_tensors = t


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")


def _card_case(B, seed):
    """A flagship-width case on the card: (front, c, rhs, masks, ctx, the
    Function's outputs, cotangents)."""
    front, c, rhs, masks = _case(B, seed=seed, device="cuda", **FLAGSHIP)
    ctx = _Ctx()
    with torch.no_grad():
        outs = fbw.RecurrenceFn.forward(ctx, front, c, rhs, masks,
                                        *_params(front))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cot = [torch.randn(o.shape, generator=gen, device="cuda") for o in outs]
    return front, c, rhs, masks, ctx, outs, cot


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [512, 64, 37])
def test_kernel_matches_plain_on_card(B):
    """Every frame's launch against frame_bwd_plain on the same inputs
    (the carries out and the rows of activation gradients, as a norm of
    the difference over the plain one's), the parameter gradients of the
    whole backward against the plain backward's; two backwards give the
    same bits; 19 launches, one a frame."""
    _need_card()
    front, c, rhs, masks, ctx, outs, cot = _card_case(B, seed=B)
    worst = {}
    real = fbw.frame_bwd_cuda

    def both(st, t, ctrl, keep, fbs, gY, gQ, gP, carry, grow):
        g2 = grow.clone()
        out = real(st, t, ctrl, keep, fbs, gY, gQ, gP, carry, grow)
        with precision_highest():
            want = fbw.frame_bwd_plain(st, t, ctrl, keep, fbs, gY, gQ, gP,
                                       carry, g2)
        pairs = list(zip(("gq", "gh"), out, want))
        if ctrl is not None:
            pairs.append(("grow", grow[:, t], g2[:, t]))
        for k, a, b in pairs:
            assert (a is None) == (b is None), (k, t)
            if a is not None:
                worst[k] = max(worst.get(k, 0.0), _rel(a, b))
        return out
    LAUNCHES.clear()
    fbw.frame_bwd_cuda = both
    try:
        got = fbw.RecurrenceFn.backward(copy.copy(ctx), *cot)
    finally:
        fbw.frame_bwd_cuda = real
    assert LAUNCHES["frontend_bwd"] == 19
    assert max(worst.values()) < 2e-5, worst
    plain = fbw.frame_bwd
    fbw.frame_bwd = lambda *a: fbw.frame_bwd_plain(*a)
    try:
        with precision_highest():
            want = fbw.RecurrenceFn.backward(copy.copy(ctx), *cot)
    finally:
        fbw.frame_bwd = plain
    rel = [_rel(a, b) for a, b in zip(got[4:], want[4:])]
    assert max(rel) < 1e-4, rel
    again = fbw.RecurrenceFn.backward(copy.copy(ctx), *cot)
    assert all(torch.equal(a, b) for a, b in zip(got[4:], again[4:]))


@pytest.mark.cuda
def test_kernel_backward_in_a_cuda_graph():
    """The whole backward captured and replayed: two replays give the
    bits of an eager backward; 19 launches counted a replay."""
    _need_card()
    from biear_tpu_torch.kernels import count_replay, recording_launches

    *_, ctx, outs, cot = _card_case(512, seed=3)
    eager = fbw.RecurrenceFn.backward(copy.copy(ctx), *cot)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fbw.RecurrenceFn.backward(copy.copy(ctx), *cot)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with recording_launches() as rec, torch.cuda.graph(graph):
        out = fbw.RecurrenceFn.backward(copy.copy(ctx), *cot)
    assert rec["frontend_bwd"] == 19
    LAUNCHES.clear()
    replays = []
    for _ in range(2):
        graph.replay()
        count_replay(rec)
        torch.cuda.synchronize()
        replays.append([x.clone() for x in out[4:]])
    assert LAUNCHES["frontend_bwd"] == 38
    for a, b, c in zip(eager[4:], *replays):
        assert torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,per_step", [("bfloat16", 19),
                                            ("float32", 0)])
def test_captured_train_chunk_launches_19_a_step(dtype, per_step):
    """The flagship's captured train chunk: 19 launches a step under the
    bf16 policy (one a frame), none under f32; finite losses, nothing
    skipped."""
    _need_card()
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    from biear_tpu_torch.models import build_active
    from biear_tpu_torch.train.loop import make_train_chunk
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer

    cfg = BiEARConfig(controller_mode="dual", deltaQ_mode="relative",
                      fb_w_dtype=dtype)
    ir, az, dist = make_test_hrir_bank()
    synth = AnechoicSynthesizer(ir, az, dist, make_test_segments(16),
                                mix_dtype="bfloat16")
    model = build_active(cfg, seed=2)
    hp = TrainHyper()
    chunk = make_train_chunk(model, hp, make_optimizer(model, hp),
                             synth.batch_fn(8), 2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    chunk(gen)
    LAUNCHES.clear()
    ms = chunk(gen)
    assert LAUNCHES["frontend_bwd"] == 2 * per_step
    assert bool(torch.isfinite(ms["loss"]).all())
    assert float(ms["skipped"].sum()) == 0.0
