"""The optimizer step's kernels (``kernels/fused_update.cu``) on the card,
against the plain version (``loop.plain_update``) on the same card.

Needs an NVIDIA GPU: every test is marked ``cuda`` and skips without one.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_fused_update_card.py

From one state and the same gradients, the kernels and the plain version
give grad_hist, the finite flags, skipped and the absolute maxima bit
for bit, the norms within 2e-6 relative, and each leaf's change of p, m
and v within 1e-5 relative of the plain one (``_fused_update_cases.
state_close``), at the flagship's and AuralNet's full leaf sets and at
fixed Q, a frozen frontend and the passive family; a NaN gradient or a
nonfinite loss leaves every state tensor's bits; lr_scale 0 leaves the
parameters'; two calls give the same bits; a replay of the captured
chunk launches the three kernels once.
"""

import copy

import pytest
import torch

import _fused_update_cases as cases


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused update's kernels run "
                    "only there")


def _names(model) -> list:
    return [n for n, _ in model.named_parameters()]


def _fused(model, opt, grads, loss, lr_scale=1.0):
    from biear_tpu_torch.train.fused_update import fused_update
    return fused_update(model, opt, grads, loss, lr_scale, 200)


def _plain(model, opt, grads, loss, lr_scale=1.0):
    from biear_tpu_torch.train.loop import plain_update
    return plain_update(model, opt, dict(zip(_names(model), grads)), loss,
                        lr_scale, 200)


@pytest.mark.cuda
@pytest.mark.parametrize("family,tiny", [
    ("dual", False), ("auralnet", False), ("fixed_q", True),
    ("freeze", True), ("passive", True)])
def test_kernels_match_the_plain_update_on_card(family, tiny):
    """Three steps from a shared state (each side re-synced after a step),
    three launches each: usual gradients twice against plain_update, then
    gradients over 18 decades against the plain update clipped by the
    kernels' norms."""
    _need_card()
    from biear_tpu_torch.kernels import LAUNCHES

    model, opt, _ = cases.build(family, "cuda", tiny)
    twin = copy.deepcopy((model, opt))
    loss = torch.tensor(0.7, device="cuda")
    for step, decades in enumerate((cases.USUAL, cases.USUAL, cases.WIDE)):
        grads = cases.gradients(model, 30 + step, decades)
        before = cases.state_of(model, opt)
        n0 = LAUNCHES["fused_update"]
        got = _fused(model, opt, grads, loss, 0.5)
        torch.cuda.synchronize()
        assert LAUNCHES["fused_update"] - n0 == 3
        if decades == cases.WIDE:
            want = cases.plain_given_norms(*twin, grads, loss, 0.5, 200,
                                           got[0])
        else:
            want = _plain(*twin, grads, loss, 0.5)
        cases.compare_updates(got, want, before, cases.state_of(model, opt),
                              cases.state_of(*twin))
        assert float(got[1]) == 0.0
        cases.sync(twin, (model, opt))


@pytest.mark.cuda
@pytest.mark.parametrize("poison", ["nan_gradient", "inf_loss"])
def test_a_nonfinite_step_keeps_the_state_on_card(poison):
    _need_card()
    model, opt, _ = cases.build("dual", "cuda", tiny=False)
    loss = torch.tensor(1.0, device="cuda")
    _fused(model, opt, cases.gradients(model, 40), loss)
    grads = cases.gradients(model, 41)
    if poison == "nan_gradient":
        grads[30].view(-1)[5] = float("nan")
    else:
        loss = torch.tensor(float("inf"), device="cuda")
    before = cases.state_of(model, opt)
    norms, skipped, _ = _fused(model, opt, grads, loss)
    want = _plain(*copy.deepcopy((model, opt)), grads, loss)
    assert float(skipped) == 1.0 == float(want[1])
    assert all(cases.bits_equal(a, b)
               for a, b in zip(before, cases.state_of(model, opt)))
    for k in norms:
        if not k.endswith("_norm"):
            assert cases.bits_equal(norms[k], want[0][k]), k


@pytest.mark.cuda
def test_lr_scale_zero_keeps_the_parameters_on_card():
    """lr_scale 0.0 (a tensor) leaves every parameter's bits; 0.5 as a
    float and as a device tensor give the same bits."""
    _need_card()
    model, opt, _ = cases.build("dual", "cuda", tiny=False)
    grads = cases.gradients(model, 42)
    loss = torch.tensor(1.0, device="cuda")
    ends = []
    for scale in (0.5, torch.tensor(0.5, device="cuda")):
        m, o = copy.deepcopy((model, opt))
        _fused(m, o, grads, loss, scale)
        ends.append(cases.state_of(m, o))
    assert all(cases.bits_equal(a, b) for a, b in zip(*ends))
    before = [p.detach().clone() for p in model.parameters()]
    _fused(model, opt, grads, loss, torch.tensor(0.0, device="cuda"))
    assert all(cases.bits_equal(a, p)
               for a, p in zip(before, model.parameters()))


@pytest.mark.cuda
def test_two_calls_give_the_same_bits_on_card():
    _need_card()
    model, opt, _ = cases.build("auralnet", "cuda", tiny=False)
    grads = cases.gradients(model, 43)
    loss = torch.tensor(1.0, device="cuda")
    outs = []
    for _ in range(2):
        m, o = copy.deepcopy((model, opt))
        norms, skipped, hist = _fused(m, o, grads, loss)
        outs.append([*norms.values(), skipped, hist,
                     *cases.state_of(m, o)])
    assert all(torch.equal(a.view(-1).view(torch.int32)
                           if a.dtype == torch.float32 else a,
                           b.view(-1).view(torch.int32)
                           if b.dtype == torch.float32 else b)
               for a, b in zip(*outs))


@pytest.mark.cuda
def test_the_captured_chunk_launches_the_kernels_once_per_replay():
    """A captured chunk of 3 steps: 3 launches a step (warm-up included
    at the first call), 9 a later call; nothing skipped."""
    _need_card()
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    from biear_tpu_torch.graph import WARMUP_STEPS
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.train.graph import CapturedChunk
    from biear_tpu_torch.train.loop import make_train_chunk
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer

    cfg = BiEARConfig(controller_mode="dual", deltaQ_mode="relative",
                      fb_w_dtype="bfloat16")
    ir, az, dist = make_test_hrir_bank()
    synth = AnechoicSynthesizer(ir, az, dist, make_test_segments(16),
                                mix_dtype="bfloat16")
    hp = TrainHyper()
    model = build_active(cfg, seed=0)
    chunk = make_train_chunk(model, hp, make_optimizer(model, hp),
                             synth.batch_fn(8), 3)
    assert isinstance(chunk, CapturedChunk)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for want in (3 * (3 + WARMUP_STEPS), 9):
        LAUNCHES.clear()
        ms = chunk(gen)
        torch.cuda.synchronize()
        assert LAUNCHES["fused_update"] == want
        assert float(ms["skipped"].sum()) == 0.0
        assert bool(torch.isfinite(ms["grad_backend_norm"]).all())
