"""Both ears' Q-controller step as one launch (``kernels/controller_fwd.cu``
through ``models/controller.py::dual_step_cuda``).

On the CPU: the dispatch (``controller.takes_kernel``) keeps the
composite ops on the CPU, under autograd, under TF32 and under autocast;
``DualFrontend.step`` there is bit for bit two per-ear ``controller_step``
calls, with and without dropout, in both next-Q modes; the CUDA entry
refuses CPU tensors before it loads the library; the kernel's yardstick
(``perfbench/bounds/controller.py``) at the flagship's and the spirit
cell's frames.

The tests marked ``cuda`` hold the kernel against the composite ops on
the card at the flagship's frame (B 512 an ear) and the spirit cell's (B
64), with and without keep-masks, in relative and absolute mode: Q', h'
and every ``Saved`` field; a NaN in one ear's band energies resets that
ear only; two launches and a graph's replays give the same bits; the
reverse recurrence fed the kernel's ``Saved`` gives the composite-fed
gradients; the captured train chunk launches it 18 times a step. This
file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_controller_fwd.py
"""

import contextlib
import copy
import os
import sys

import pytest
import torch

from biear_tpu_torch.kernels import LAUNCHES, build
from biear_tpu_torch.models import BiEARConfig
from biear_tpu_torch.models import controller as tctrl
from biear_tpu_torch.models import frontend as tfe
from biear_tpu_torch.models import frontend_bwd as fbw
from biear_tpu_torch.models.layers import dropout_masks, init_module_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from perfbench import bounds  # noqa: E402
from perfbench.bounds import controller as cbound  # noqa: E402
from perfbench.bounds import frontend as fbound  # noqa: E402

SMALL = dict(fs=1600, timesteps=4, n_fft=64, n_bands=9, fmin=50.0,
             fmax=700.0, latent_dim=8, ctrl_hidden=8, deltaQ_mode="relative",
             deltaQ_base=1.0, deltaQ_low_factor=0.3, deltaQ_high_factor=5.0,
             fb_w_dtype="bfloat16")
# the flagship's widths (conf/config.yaml), for the card
FLAGSHIP = dict(SMALL, fs=16000, timesteps=19, n_fft=1024, n_bands=100,
                fmax=None, latent_dim=100, ctrl_hidden=128)
ABSOLUTE = dict(deltaQ_mode="absolute", deltaQ_base=2.0,
                deltaQ_low_factor=0.5, deltaQ_high_factor=1.0)


def _front(seed=0, device="cpu", out_scale=0.3, **kw):
    """A DualFrontend with seeded weights, the output layer off zero (by
    `out_scale` standard deviations) so that Q moves, and its
    constants."""
    cfg = BiEARConfig(**{**SMALL, **kw})
    front = tfe.DualFrontend(cfg)
    gen = torch.Generator().manual_seed(seed)
    init_module_(front, gen)
    with torch.no_grad():
        for ctrl in front.controllers():
            for p in ctrl.q_out[8].parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * out_scale)
    return front.to(device), tfe.device_constants(cfg, device)


def _frame(front, B, seed=1, device="cpu", dropout=True):
    """A frame's step inputs: band energies Y (2, B, N) spread over
    decades, with exact zeros; a hidden state h (2, B, H) in (-1, 1);
    keep-masks (2, 2, B, H) or None."""
    cfg = front.cfg
    N, H = cfg.n_bands, cfg.ctrl_hidden
    g = torch.Generator(device=device).manual_seed(seed)
    Y = torch.exp(3.0 * torch.randn((2, B, N), generator=g, device=device))
    Y = torch.where(torch.rand(Y.shape, generator=g, device=device) < 0.05,
                    0.0, Y)
    h = torch.rand((2, B, H), generator=g, device=device) * 2 - 1
    drops = (dropout_masks(g, cfg.ctrl_dropout, (2, 2, B, H))
             if dropout else None)
    return Y, h, drops


def _per_ear(front, c, h, Y, drops):
    """The step as two controller_step calls, as the parent ran it."""
    cfg = front.cfg
    out = []
    for e, ctrl in enumerate(front.controllers()):
        Y_ctrl = torch.log1p(torch.clamp(Y[e], min=0.0))
        feat = torch.cat([Y_ctrl, 0.2 * Y_ctrl.detach()], dim=-1)
        out.append(tctrl.controller_step(
            cfg, c, h[e], feat, None if drops is None else drops[e],
            tctrl.controller_params(ctrl)))
    (QL, hL, sL), (QR, hR, sR) = out
    return torch.stack([QL, QR]), torch.stack([hL, hR]), (sL, sR)


class _OnCard:
    """Stands in for a CUDA tensor in the dispatch predicate."""
    is_cuda = True


@pytest.mark.parametrize("case,takes", [
    ("card", True), ("cpu", False), ("autograd", False),
    ("tf32-matmul", False), ("tf32-cudnn", False), ("autocast", False)])
def test_the_kernel_is_taken_only_on_the_card_without_grad_in_f32(
        monkeypatch, case, takes):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    Y = torch.zeros(2, 1, 3) if case == "cpu" else _OnCard()
    if case == "tf32-matmul":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    if case == "tf32-cudnn":
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    if case == "autocast":
        real = torch.is_autocast_enabled
        monkeypatch.setattr(torch, "is_autocast_enabled",
                            lambda *a: True if a == ("cuda",) else real(*a))
    grad = torch.enable_grad() if case == "autograd" else torch.no_grad()
    with grad:
        assert tctrl.takes_kernel(Y) is takes


@pytest.mark.parametrize("dropout", [True, False], ids=["drop", "nodrop"])
@pytest.mark.parametrize("mode", ["relative", "absolute"])
@pytest.mark.parametrize("grad", [False, True], ids=["nograd", "grad"])
def test_step_on_the_cpu_is_two_controller_steps_bit_for_bit(dropout, mode,
                                                             grad):
    front, c = _front(seed=3, **(ABSOLUTE if mode == "absolute" else {}))
    Y, h, drops = _frame(front, 5, seed=4, dropout=dropout)
    ctx = contextlib.nullcontext() if grad else torch.no_grad()
    with ctx:
        (Q, hn), saved = front.step(c, (None, h), Y, drops)
        Qw, hw, want = _per_ear(front, c, h, Y, drops)
    assert torch.equal(Q, Qw) and torch.equal(hn, hw)
    for got, ref in zip(saved, want):
        for k in tctrl.Saved._fields:
            assert torch.equal(getattr(got, k), getattr(ref, k)), k
    assert not torch.equal(Q, c["Q0"].expand_as(Q))


def test_the_loops_never_launch_the_kernel_on_the_cpu(monkeypatch):
    """The Function's forward (gradients off), the no-grad loop and the
    autograd loop on the CPU: no launch counted, no shape recorded, the
    library never loaded."""
    calls = []
    monkeypatch.setattr(build, "controller_fwd_lib",
                        lambda: calls.append(1) or None)
    front, c = _front(seed=5)
    cfg = front.cfg
    B = 2
    g = torch.Generator().manual_seed(6)
    wav = torch.rand((2, B, cfg.fs), generator=g) * 2 - 1
    sL, sR = (tfe.spectra(cfg, w, c) for w in wav)
    from biear_tpu_torch.ops.filterbank import stack_rhs
    rhs = torch.cat([stack_rhs(*sL, True),
                     stack_rhs(*sR, True)]).transpose(0, 1)
    masks = dropout_masks(g, cfg.ctrl_dropout,
                          (cfg.timesteps, 2, 2, B, cfg.ctrl_hidden))
    LAUNCHES.clear()
    tctrl.LAUNCH_SHAPES.clear()
    outs = front.recurrence(c, rhs, masks)
    with torch.no_grad():
        front.frame_loop(c, rhs, masks)
    front.frame_loop(c, rhs, masks)
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    assert calls == [] and LAUNCHES["controller_fwd"] == 0
    assert not tctrl.LAUNCH_SHAPES


def test_row_tiles_make_about_one_block_a_sm():
    """controller_fwd.cu's blocks of 512 threads, one a SM of 132: 8 rows
    a block at the flagship's 512 an ear (128 blocks), 1 at the spirit
    cell's 64 (128 blocks)."""
    assert tctrl.row_tile(512, 132 // 2) == 8
    assert tctrl.row_tile(64, 132 // 2) == 1
    assert tctrl.row_tile(100, 132 // 2) == 2


def test_the_cuda_entry_refuses_cpu_tensors_before_the_library(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "controller_fwd_lib",
                        lambda: calls.append(1) or None)
    monkeypatch.setattr(tfe, "takes_kernel", lambda Y: True)
    front, c = _front(seed=7)
    Y, h, drops = _frame(front, 3, seed=8)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        front.step(c, (None, h), Y, drops)
    assert calls == [] and LAUNCHES["controller_fwd"] == 0


H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("rows", [1024, 128], ids=["A", "D"])
def test_the_bound_at_the_flagship_and_spirit_frames(rows):
    """171,520 multiply-adds a row at N 100, H 128, 200 GRU inputs: the
    GRU's input (3H x 2N) and hidden (3H x H) products, Linear 0 and 4
    (H^2 each) and Linear 8 (N x H); 10,352 bytes a row (Y, h and the
    masks read; the saved set, Q' and h' written) and both ears' weights
    once. At the flagship's 1,024 rows the multiply-adds bound it: 5.25
    us at 33.45e12 f32 FMA/s; at the spirit cell's 128 the bytes, most of
    them the weights (0.81 us at 3.35 TB/s)."""
    macs, nbytes = cbound.controller_fwd(rows, 100, 128, 200)
    assert 76800 + 49152 + 2 * 16384 + 12800 == 171520
    assert macs == rows * 171520
    per_row = 4 * (100 + 128) + 2 * 128 + 4 * (200 + 13 * 128 + 4 + 200) \
        + 4 * (100 + 128)
    assert per_row == 10352
    assert nbytes == rows * per_row + 8 * (171520 + 12 * 128 + 100)
    t, by = bounds.least_time(macs, nbytes, fbound.fma_peak(H100),
                              bounds.peak(H100, "hbm_bytes"))
    if rows == 1024:
        assert by == "operations"
        assert t == pytest.approx(rows * 171520 / 33.4541e12, rel=1e-4)
        assert t == pytest.approx(5.25e-6, rel=2e-3)
    else:
        assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
        assert t == pytest.approx(0.809e-6, rel=2e-3)


# ---------------------------------------------------------------- the card

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# a field's norm of difference over the composite one's: the products'
# f32 sums in another order (rounding ~1e-7 relative) carried through the
# LayerNorms and the gates
CARD_REL = 2e-5


def _card(B, seed, mode="relative", dropout=True):
    front, c = _front(seed=seed, device="cuda",
                      **{**FLAGSHIP, **(ABSOLUTE if mode == "absolute"
                                        else {})})
    Y, h, drops = _frame(front, B, seed=seed + 1, device="cuda",
                         dropout=dropout)
    ears = [tctrl.controller_params(ctrl) for ctrl in front.controllers()]
    return front, c, Y, h, drops, ears


def _compare(got, want, outs=True):
    (Q, hn, saved), (Qw, hw, ref) = got, want
    worst = {"Q": _rel(Q, Qw), "h": _rel(hn, hw)} if outs else {}
    for s, r in zip(saved, ref):
        assert bool(s.ok) == bool(r.ok)
        for k in tctrl.Saved._fields[:-1]:
            a, b = getattr(s, k), getattr(r, k)
            assert a.shape == b.shape and a.is_contiguous(), k
            worst[k] = max(worst.get(k, 0.0), _rel(a, b))
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("B", [512, 64])
@pytest.mark.parametrize("dropout", [True, False], ids=["drop", "nodrop"])
@pytest.mark.parametrize("mode", ["relative", "absolute"])
def test_kernel_matches_the_composite_ops_on_card(B, dropout, mode):
    _need_card()
    front, c, Y, h, drops, ears = _card(B, B + 1, mode, dropout)
    with torch.no_grad():
        LAUNCHES.clear()
        got = tctrl.dual_step_cuda(front.cfg, c, h, Y, drops, ears)
        want = _per_ear(front, c, h, Y, drops)
    assert LAUNCHES["controller_fwd"] == 1
    worst = _compare(got, want)
    assert max(worst.values()) < CARD_REL, worst
    Q = got[0]
    assert bool((Q != c["Q0"]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [512, 64])
def test_a_nan_in_one_ear_resets_that_ear_only(B):
    _need_card()
    front, c, Y, h, drops, ears = _card(B, 20 + B)
    Y = Y.clone()
    Y[1, B // 3, 7] = float("nan")
    with torch.no_grad():
        Q, hn, saved = tctrl.dual_step_cuda(front.cfg, c, h, Y, drops, ears)
        Qw, hw, ref = _per_ear(front, c, h, Y, drops)
    assert not bool(saved[1].ok) and bool(saved[0].ok)
    assert torch.equal(Q[1], c["Q0"].expand(B, -1))
    assert torch.equal(hn[1], torch.zeros_like(hn[1]))
    assert torch.equal(Q[1], Qw[1]) and torch.equal(hn[1], hw[1])
    assert _rel(Q[0], Qw[0]) < CARD_REL and _rel(hn[0], hw[0]) < CARD_REL
    assert bool(torch.isnan(saved[1].qraw[B // 3]).all())


@pytest.mark.cuda
def test_two_launches_and_graph_replays_give_the_same_bits():
    _need_card()
    from biear_tpu_torch.kernels import count_replay, recording_launches

    front, c, Y, h, drops, ears = _card(512, 31)

    def run():
        Q, hn, saved = tctrl.dual_step_cuda(front.cfg, c, h, Y, drops, ears)
        return [Q, hn] + [getattr(s, k) for s in saved
                          for k in tctrl.Saved._fields]
    first, again = run(), run()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with recording_launches() as rec, torch.cuda.graph(graph):
        out = run()
    assert rec["controller_fwd"] == 1
    LAUNCHES.clear()
    for _ in range(2):
        graph.replay()
        count_replay(rec)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, out))
    assert LAUNCHES["controller_fwd"] == 2
    # a reset inside the graph, then none: the counters start from zero
    Y[0, 3, 2] = float("nan")
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0][0], c["Q0"].expand(512, -1))
    assert torch.equal(out[0][1], first[0][1])
    Y[0, 3, 2] = 1.0
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(out[0][0], c["Q0"].expand(512, -1))


class _Ctx:
    """A stand-in for autograd's ctx, to run the Function by hand."""
    needs_input_grad = (False,) * 40

    def save_for_backward(self, *t):
        self.saved_tensors = t


@pytest.mark.cuda
@pytest.mark.parametrize("B", [512, 64])
def test_the_reverse_recurrence_on_the_kernels_saved_set(monkeypatch, B):
    """The Function's forward over the flagship's 19 frames (dropout on)
    with the composite step, then every frame's step again by the kernel
    from the same band energies, hidden state and masks: the backward's
    parameter gradients from the kernel's saved sets within the reverse
    recurrence's own limit against its plain twin (1e-4) of those from the
    composite's. The Function's forward with the kernel launches it 18
    times and gives Y and Q within 1e-4 of the composite's after 18 frames
    of the recurrence (the band phase, which wraps at +-pi where a band's
    sum is near zero, is left out). The output layer is moved off zero by
    0.03 standard deviations: at 0.3 most of tanh's outputs sit within an
    ulp of +-1, where 1 - delta^2 moves by 100 % with one ulp of delta, so
    any other order of the products' sums moves some gradients by 1e-3."""
    _need_card()
    from biear_tpu_torch.ops.filterbank import stack_rhs

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    front, c = _front(seed=B, device="cuda", out_scale=0.03, **FLAGSHIP)
    cfg = front.cfg
    N, H = cfg.n_bands, cfg.ctrl_hidden
    gen = torch.Generator(device="cuda").manual_seed(B)
    wav = torch.rand((2, B, cfg.fs), generator=gen, device="cuda") * 2 - 1
    sL, sR = (tfe.spectra(cfg, w, c) for w in wav)
    rhs = torch.cat([stack_rhs(*sL, True),
                     stack_rhs(*sR, True)]).transpose(0, 1)
    masks = dropout_masks(gen, cfg.ctrl_dropout, (cfg.timesteps, 2, 2, B, H))
    ears = [tctrl.controller_params(ctrl) for ctrl in front.controllers()]
    params = ears[0] + ears[1]

    def forward():
        ctx = _Ctx()
        with torch.no_grad():
            outs = fbw.RecurrenceFn.forward(ctx, front, c, rhs, masks,
                                            *params)
        return ctx, outs
    LAUNCHES.clear()
    _, outs = forward()
    assert LAUNCHES["controller_fwd"] == cfg.timesteps - 1
    real = tfe.takes_kernel
    monkeypatch.setattr(tfe, "takes_kernel", lambda Y: False)
    ctx, outs_w = forward()
    monkeypatch.setattr(tfe, "takes_kernel", real)
    assert _rel(outs[0], outs_w[0]) < 1e-4 and _rel(outs[1], outs_w[1]) < 1e-4
    kctx = copy.copy(ctx)
    kctx.ctrls = []
    with torch.no_grad():
        for t, (sl, sr) in enumerate(ctx.ctrls):
            Y = ctx.fbs[t][3].reshape(2, B, N)
            h = torch.stack([sl.ws[:, 3 * H:4 * H], sr.ws[:, 3 * H:4 * H]])
            kctx.ctrls.append(tctrl.dual_step_cuda(cfg, c, h, Y, masks[t],
                                                   ears)[2])
    worst = {}
    for k_s, w_s in zip(kctx.ctrls, ctx.ctrls):
        for k, v in _compare((None, None, k_s), (None, None, w_s),
                             outs=False).items():
            worst[k] = max(worst.get(k, 0.0), v)
    assert max(worst.values()) < CARD_REL, worst
    cot = [torch.randn(o.shape, generator=gen, device="cuda") for o in outs]
    got = fbw.RecurrenceFn.backward(kctx, *cot)
    want = fbw.RecurrenceFn.backward(copy.copy(ctx), *cot)
    rel = {name: _rel(a, b) for name, a, b in zip(
        [f"{e}.{n}" for e in ("L", "R") for n in tctrl.PARAM_NAMES],
        got[4:], want[4:])}
    assert max(rel.values()) < 1e-4, rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,per_step", [("bfloat16", 18),
                                            ("float32", 0)])
def test_captured_train_chunk_launches_18_a_step(dtype, per_step):
    """The flagship's captured train chunk: one launch a frame whose
    controller step runs (18 of 19) under the bf16 policy, whose forward
    runs with gradients off inside the recurrence Function; none under
    f32, whose loop runs under autograd. Finite losses, nothing
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
    assert LAUNCHES["controller_fwd"] == 2 * per_step
    assert bool(torch.isfinite(ms["loss"]).all())
    assert float(ms["skipped"].sum()) == 0.0
