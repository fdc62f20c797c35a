"""The single frontend's reverse recurrence (``models/frontend_bwd.py``).

On the CPU the Function's plain backward over the one shared controller
is held against autograd through the loop of ``SingleFrontend.frame``
(``frame_loop``) on the same weights, spectra and dropout masks: the
outputs bit for bit, every controller parameter's gradient (and a spectra
gradient of zero) to float32 rounding. Cases: with and without dropout,
an odd batch, absolute and relative next-Q rules, Q pinned at q_min and
at q_max, a frame where the finite reset fires, rows whose Y is
nonfinite (the finite mask), a Q-regulariser loss on the Q output, every
row of activation gradients written. The routing: the single frontend
takes the Function under the bf16|noxg policy with the custom VJP, f32
products and autograd, and keeps the loop otherwise.

The tests marked ``cuda`` hold ``kernels/frontend_bwd.cu``'s single
entry against the plain backward on the card, frame by frame, at the
published single-controller frame (512 rows, N 100, H 128, 400 GRU
inputs) and at small ones, replayed in a CUDA graph and inside the
captured train chunk (19 launches a step). This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_single_bwd.py
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
from test_torch_port_frontend_bwd import (_Ctx, _close, _cot_loss,
                                          _need_card, _rel)

# conf/config_single_ctrl.yaml's controller rule at a small width
SMALL = dict(controller_mode="single", fs=1600, timesteps=4, n_fft=64,
             n_bands=9, fmin=50.0, fmax=700.0, latent_dim=8, ctrl_hidden=8,
             deltaQ_mode="absolute", deltaQ_base=2.0, deltaQ_low_factor=0.5,
             deltaQ_high_factor=5.0, fb_w_dtype="bfloat16")
# the published widths (perfbench/configs/biear-single.json), for the card
PUBLISHED = dict(SMALL, fs=16000, timesteps=19, n_fft=1024, n_bands=100,
                 fmax=None, latent_dim=100, ctrl_hidden=128)


def _case(B=3, seed=0, device="cpu", dropout=True, **kw):
    """(front, c, rhs (T, 2B, 4, F) bf16, masks or None): a SingleFrontend
    with seeded weights (the output layer off zero, so Q moves), spectra
    of random waveforms, keep-masks (T, 2, B, H) from a generator."""
    cfg = BiEARConfig(**{**SMALL, **kw})
    front = tfe.SingleFrontend(cfg)
    gen = torch.Generator().manual_seed(seed)
    init_module_(front, gen)
    with torch.no_grad():
        for p in front.q_out[8].parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    front = front.to(device)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    wav = torch.rand((2, B, cfg.fs), generator=g, device=device) * 2 - 1
    c = tfe.device_constants(cfg, device)
    sL, sR = (tfe.spectra(cfg, w, c) for w in wav)
    rhs = torch.cat([stack_rhs(*sL, True),
                     stack_rhs(*sR, True)]).transpose(0, 1)
    masks = (dropout_masks(g, cfg.ctrl_dropout,
                           (cfg.timesteps, 2, B, cfg.ctrl_hidden))
             if dropout else None)
    return front, c, rhs, masks


def _params(front):
    return tctrl.controller_params(front)


def _grads(front, outs, loss_fn, extra=()):
    loss = loss_fn(*outs)
    return torch.autograd.grad(loss, _params(front) + list(extra))


def _compare(front, c, rhs, masks, loss_fn=None, rhs_grad=False):
    """Outputs and gradients of the Function and of the loop: one shared
    forward (``frame_loop``), held to the same bits with and without the
    Function, and the hand backward against autograd through it. Returns
    the Function's outputs and gradients."""
    extra = []
    if rhs_grad:
        rhs = rhs.detach().float().requires_grad_()
        extra = [rhs]
    x = rhs.to(torch.bfloat16) if rhs_grad else rhs
    assert front.loop_path(x) == "recurrence"
    new = front.recurrence(c, x, masks)
    old = front.frame_loop(c, x, masks)
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


def test_relative_next_q_matches_autograd():
    front, c, rhs, masks = _case(3, seed=4, deltaQ_mode="relative",
                                 deltaQ_base=1.0, deltaQ_low_factor=0.3)
    _compare(front, c, rhs, masks)


def test_q_pinned_at_both_clamp_ends_matches_autograd():
    """q_min and q_max inside Q0's range: bands sit at each end of the
    clamp, where no gradient passes."""
    front, c, rhs, masks = _case(3, seed=5, q_min=2.0, q_max=4.0)
    Q = _compare(front, c, rhs, masks)[0][1]
    assert bool((Q == 2.0).any()) and bool((Q == 4.0).any())
    assert bool(((Q > 2.0) & (Q < 4.0)).any())


def test_finite_reset_matches_autograd(monkeypatch):
    """A NaN in the next Q at frame 1 resets the shared controller (Q to
    Q0, h to zero) there, for both ears; the memories run on."""
    front, c, rhs, masks = _case(3, seed=6, timesteps=5)
    real = tctrl.q_unclamped
    calls = []

    def poisoned(cfg, c, delta):
        q = real(cfg, c, delta)
        calls.append(1)
        if len(calls) == 2:                # frame 1's step
            q = q.clone()
            q[1, 2] = float("nan")
        return q
    monkeypatch.setattr(tctrl, "q_unclamped", poisoned)

    def run(fn):
        calls.clear()
        return fn(front, c, rhs, masks)
    new = run(tfe.SingleFrontend.recurrence)
    old = run(tfe.SingleFrontend.frame_loop)
    for a, b in zip(new, old):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    Q = new[1]
    assert torch.equal(Q[:, :, 2], c["Q0"].expand(2, 3, -1))
    assert not torch.equal(Q[:, :, 1], c["Q0"].expand(2, 3, -1))
    loss_fn = _cot_loss(8, old)
    got = _grads(front, run(tfe.SingleFrontend.recurrence), loss_fn)
    want = _grads(front, run(tfe.SingleFrontend.frame_loop), loss_fn)
    _close(got, want)
    assert all(bool(torch.isfinite(g).all()) for g in got)


def test_nonfinite_y_rows_match_autograd():
    """Spectra of 1e38 overflow some bands' Y sums in the right ear:
    those Y are zeroed (finite mask False) and take no gradient, in both
    paths; the shared Q still takes the left ear's. (At 3e38 the
    filterbank's saved T overflows too, and both paths' gradients are
    NaN alike.)"""
    front, c, rhs, masks = _case(3, seed=9)
    rhs = rhs.clone()
    rhs[1:3, 3 + 1, 0, 20:27] = 1.0e38
    outs, grads = _compare(front, c, rhs, masks)
    assert bool((outs[0][1, 1, 1:3] == 0).any())
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_q_regulariser_loss_and_spectra_gradient():
    """The training loss's Q regularisers on the Q output (both ears' Q,
    one tensor: its gradient sums over them), plus the Y and phase
    outputs; spectra that require a gradient get zeros (no spectra
    gradient under bf16|noxg), as from the loop."""
    front, c, rhs, masks = _case(3, seed=10)
    Q0 = c["Q0"]

    def loss(Y, Q, P):
        return (q_regularizers(0.5 * (Q[0] + Q[1]), Q0, 1e-3, 1e-3)
                + 0.1 * (torch.log(Y + 1e-8)).mean() + P.square().mean())
    _compare(front, c, rhs, masks, loss, rhs_grad=True)


def test_plain_frames_write_every_activation_gradient_row(monkeypatch):
    """grow (1, T-1, B, 12 H + N) is written in full by the frames of the
    backward (here its allocation is filled with NaN first); the
    controller reads the left ear's Y at feature columns 0:N and the
    right's at 2N:3N."""
    front, c, rhs, masks = _case(2, seed=11)
    seen = []
    real_grads, real_empty = fbw.weight_grads, torch.empty

    def spy(st, grow, ctrls, params):
        assert st.y_cols == (0, 18) and len(st.weights) == 1
        seen.append(grow.clone())
        return real_grads(st, grow, ctrls, params)
    monkeypatch.setattr(fbw, "weight_grads", spy)
    monkeypatch.setattr(torch, "empty", lambda *a, **k: real_empty(
        *a, **k).fill_(float("nan")))
    outs = front.recurrence(c, rhs, masks)
    torch.autograd.grad(sum(o.sum() for o in outs), _params(front))
    assert seen[0].shape == (1, 3, 2, fbw.grow_layout(8, 9)["width"])
    assert bool(torch.isfinite(seen[0]).all())


@pytest.mark.parametrize("mode", ["dual", "single"])
def test_y_cols_are_where_the_step_reads_each_ears_y(monkeypatch, mode):
    """Each frontend's ``y_cols()`` name the feature columns at which its
    step puts each ear's log1p(max(Y, 0)): the columns the backward takes
    the controller's gradient of Y through (controller e of the dual
    reads ear e, the single controller both)."""
    cfg = BiEARConfig(**{**SMALL, "controller_mode": mode})
    front = (tfe.DualFrontend if mode == "dual" else tfe.SingleFrontend)(cfg)
    c = tfe.device_constants(cfg, "cpu")
    N, B = cfg.n_bands, 3
    feats = []
    real = tfe.controller_step
    monkeypatch.setattr(tfe, "controller_step", lambda cfg_, c_, h, feat,
                        *a: feats.append(feat) or real(cfg_, c_, h, feat,
                                                       *a))
    Y = torch.randn((2, B, N), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        front.step(c, front.init_carry(c, B, "cpu"), Y)
    assert len(feats) == len(front.controllers())
    for e, feat in enumerate(feats):
        for k, col in enumerate(front.y_cols()):
            want = torch.log1p(torch.clamp(Y[e + k], min=0.0))
            assert torch.equal(feat[:, col:col + N], want)


@pytest.mark.parametrize("change,path", [
    ({}, "recurrence"), ({"fb_w_dtype": "float32"}, "autograd"),
    ({"fb_x_grad": True}, "autograd"), ({"fb_vjp": "autodiff"}, "autograd"),
    ({"freeze_q": True}, "autograd")],
    ids=["bf16-noxg", "f32", "x-grad", "autodiff", "freeze-q"])
def test_the_single_frontend_takes_the_function_under_bf16_noxg(
        monkeypatch, change, path):
    """The single model's training forward takes the Function under the
    production policy only; never without autograd (predict, eval,
    streaming) nor with no parameter to train."""
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
    assert calls == ([1] if path == "recurrence" else [])
    assert model.bifb.loop_path(wav) == path
    if path == "recurrence":
        torch.autograd.grad(out[2].sum() + out[0].sum(),
                            list(model.bifb.parameters()))
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
    fbw.SINGLE_LAUNCH_SHAPES.clear()
    outs = front.recurrence(c, rhs, masks)
    torch.autograd.grad(sum(o.sum() for o in outs), _params(front))
    assert calls == [] and LAUNCHES["single_bwd"] == 0
    assert not fbw.SINGLE_LAUNCH_SHAPES
    ctx = _Ctx()
    with torch.no_grad():
        fbw.RecurrenceFn.forward(ctx, front, c, rhs, masks, *_params(front))
    st = fbw.Statics(front.cfg, c, ctx.saved_tensors, 2, 4,
                     front.y_cols())
    g = torch.zeros((2, 2, 4, 9))
    grow = torch.empty((1, 3, 2, fbw.grow_layout(8, 9)["width"]))
    keep = masks[2].reshape(1, 2, 2, 8)
    with pytest.raises(ValueError, match="single_bwd .*CUDA"):
        fbw.frame_bwd_cuda(st, 2, ctx.ctrls[2], keep, ctx.fbs[2], g, g, g,
                           (torch.zeros(1, 2, 9), None), grow)
    assert calls == []


# ---------------------------------------------------------------- the card

def _card_case(B, seed, **kw):
    """A case on the card: (ctx, the Function's outputs, cotangents)."""
    front, c, rhs, masks = _case(B, seed=seed, device="cuda", **kw)
    ctx = _Ctx()
    with torch.no_grad():
        outs = fbw.RecurrenceFn.forward(ctx, front, c, rhs, masks,
                                        *_params(front))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cot = [torch.randn(o.shape, generator=gen, device="cuda") for o in outs]
    return ctx, outs, cot


@pytest.mark.cuda
@pytest.mark.parametrize("B,widths", [(512, PUBLISHED), (37, PUBLISHED),
                                      (5, {})],
                         ids=["published-512", "published-37", "small-5"])
def test_kernel_matches_plain_on_card(B, widths):
    """Every frame's launch against frame_bwd_plain on the same inputs
    (the carries out and the rows of activation gradients, as a norm of
    the difference over the plain one's), the parameter gradients of the
    whole backward against the plain backward's; two backwards give the
    same bits; one launch a frame, each recorded at its shape."""
    _need_card()
    ctx, outs, cot = _card_case(B, seed=B, **widths)
    T = len(ctx.fbs)
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
    fbw.SINGLE_LAUNCH_SHAPES.clear()
    fbw.frame_bwd_cuda = both
    try:
        got = fbw.RecurrenceFn.backward(copy.copy(ctx), *cot)
    finally:
        fbw.frame_bwd_cuda = real
    assert LAUNCHES["single_bwd"] == T and LAUNCHES["frontend_bwd"] == 0
    cfg = BiEARConfig(**{**SMALL, **widths})
    key = (B, cfg.n_bands, cfg.ctrl_hidden, 4 * cfg.n_bands)
    assert dict(fbw.SINGLE_LAUNCH_SHAPES) == {
        key + (True, True): T - 2, key + (False, True): 1,
        key + (True, False): 1}
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

    ctx, outs, cot = _card_case(512, seed=3, **PUBLISHED)
    eager = fbw.RecurrenceFn.backward(copy.copy(ctx), *cot)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fbw.RecurrenceFn.backward(copy.copy(ctx), *cot)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with recording_launches() as rec, torch.cuda.graph(graph):
        out = fbw.RecurrenceFn.backward(copy.copy(ctx), *cot)
    assert rec["single_bwd"] == 19
    LAUNCHES.clear()
    replays = []
    for _ in range(2):
        graph.replay()
        count_replay(rec)
        torch.cuda.synchronize()
        replays.append([x.clone() for x in out[4:]])
    assert LAUNCHES["single_bwd"] == 38
    for a, b, c in zip(eager[4:], *replays):
        assert torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,per_step", [("bfloat16", 19),
                                            ("float32", 0)])
def test_captured_train_chunk_launches_19_a_step(dtype, per_step):
    """The single controller's captured train chunk: 19 launches of the
    single entry a step under the bf16 policy (one a frame), none under
    f32, and none of the dual entry; finite losses, nothing skipped."""
    _need_card()
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    from biear_tpu_torch.models import build_active
    from biear_tpu_torch.train.loop import make_train_chunk
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer

    cfg = BiEARConfig(controller_mode="single", deltaQ_mode="absolute",
                      deltaQ_base=2.0, deltaQ_low_factor=0.5,
                      deltaQ_high_factor=5.0, fb_w_dtype=dtype)
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
    assert LAUNCHES["single_bwd"] == 2 * per_step
    assert LAUNCHES["frontend_bwd"] == 0
    assert bool(torch.isfinite(ms["loss"]).all())
    assert float(ms["skipped"].sum()) == 0.0
