"""The captured train step and chunk on the card, against the eager loop.

Needs an NVIDIA GPU: every test is marked ``cuda`` and skips without one.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_capture_card.py

From one seeded state and generator seed, the captured chunk
(``make_train_chunk`` on the card) and the eager loop (``capture=False``)
give the same batches and generator state bit for bit, and losses and
parameters within CAPTURE_WITNESS times the spread of two eager runs (the
backward's atomic sums may differ from run to run; where the two eager
runs agree, exactly). A replay reads the current lr_scale, refuses a
parameter given new storage and another generator, and the bf16
MATMUL_PRECISION (autocast) captures. ``chip_smoke.py`` phase 18 runs the
same checks at batch 512.
"""

import pytest
import torch

CAPTURE_WITNESS = 3.0   # chip_smoke.py's


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the captured path runs only there")


def _setup(steps=3, B=8, **kw):
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.train.loop import make_train_chunk
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer

    cfg = BiEARConfig(controller_mode="dual", deltaQ_mode="relative",
                      fb_w_dtype="bfloat16", **kw)
    ir, az, dist = make_test_hrir_bank()
    synth = AnechoicSynthesizer(ir, az, dist, make_test_segments(16),
                                mix_dtype="bfloat16")
    hp = TrainHyper()
    runs = {}
    for name, capture in (("eager", False), ("witness", False),
                          ("captured", True)):
        model = build_active(cfg, seed=0)
        opt = make_optimizer(model, hp)
        runs[name] = (model, opt, make_train_chunk(
            model, hp, opt, synth.batch_fn(B), steps, capture=capture),
            torch.Generator(device="cuda"))
    return runs, synth


def _max_abs(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


@pytest.mark.cuda
def test_captured_chunk_matches_the_eager_loop_on_card():
    _need_card()
    from biear_tpu_torch.graph import WARMUP_STEPS
    from biear_tpu_torch.train.graph import CapturedChunk
    from biear_tpu_torch.kernels import LAUNCHES

    runs, _ = _setup()
    assert isinstance(runs["captured"][2], CapturedChunk)
    assert not isinstance(runs["eager"][2], CapturedChunk)
    for c in range(2):
        out = {}
        for name, (model, _, chunk, gen) in runs.items():
            gen.manual_seed(50 + c)
            LAUNCHES.clear()
            out[name] = (chunk(gen), [p.detach().clone()
                                      for p in model.parameters()],
                         gen.get_state())
            torch.cuda.synchronize()
            if name == "captured":
                want = 3 + (WARMUP_STEPS if c == 0 else 0)
                assert LAUNCHES["gather_mix_kb"] == want
                assert LAUNCHES["cc_lags"] == want
        (me, pe, ge), (mw, pw, gw), (mc, pc, gc) = (
            out["eager"], out["witness"], out["captured"])
        assert torch.equal(gc, ge) and torch.equal(gw, ge)
        assert list(mc) == list(me)
        for a, b, w in ((mc["loss"], me["loss"], mw["loss"]), (pc, pe, pw)):
            a, b, w = ([a], [b], [w]) if isinstance(a, torch.Tensor) else (
                a, b, w)
            assert _max_abs(a, b) <= CAPTURE_WITNESS * _max_abs(w, b)
        assert float(mc["skipped"].sum()) == 0.0


@pytest.mark.cuda
def test_captured_chunk_reads_lr_scale_and_refuses_new_storage():
    _need_card()
    runs, _ = _setup(steps=2)
    model, _, chunk, gen = runs["captured"]
    gen.manual_seed(0)
    chunk(gen)
    before = [p.detach().clone() for p in model.parameters()]
    chunk(gen, 0.0)
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    chunk(gen, torch.tensor(1.0, device="cuda"))
    assert not all(torch.equal(a, p)
                   for a, p in zip(before, model.parameters()))
    with pytest.raises(ValueError, match="generator"):
        chunk(torch.Generator(device="cuda"))
    p = next(model.parameters())
    kept = p.data
    p.data = kept.clone()
    with pytest.raises(RuntimeError, match="new storage"):
        chunk(gen)
    p.data = kept
    assert bool(torch.isfinite(chunk(gen)["loss"]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["default", "bfloat16"])
def test_captured_step_matches_the_eager_step_on_card(precision):
    """Three bare steps on one batch, captured (under the MATMUL_PRECISION
    name: bf16 autocast without its cast cache) and eager, from one state
    and seed: losses and parameters within the witness."""
    _need_card()
    from biear_tpu_torch.device import matmul_precision
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.train.graph import CapturedStep
    from biear_tpu_torch.train.loop import make_train_step
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer
    from biear_tpu_torch.train.profile_train import fixed_batch

    cfg = BiEARConfig(controller_mode="dual", deltaQ_mode="relative",
                      n_bands=32, latent_dim=32, ctrl_hidden=32)
    batch = fixed_batch(8, cfg.n_bands, 0, "cuda")
    hp = TrainHyper()
    out = {}
    for name, capture in (("eager", False), ("witness", False),
                          ("captured", True)):
        model = build_active(cfg, seed=0)
        step = make_train_step(model, hp, make_optimizer(model, hp),
                               capture=capture)
        assert isinstance(step, CapturedStep) == capture
        gen = torch.Generator(device="cuda").manual_seed(4)
        with matmul_precision(precision):
            losses = torch.stack([step(batch, gen)["loss"]
                                  for _ in range(3)])
        out[name] = ([losses], [p.detach() for p in model.parameters()])
    for i in range(2):
        e, w, c = (out[k][i] for k in ("eager", "witness", "captured"))
        assert _max_abs(c, e) <= CAPTURE_WITNESS * _max_abs(w, e)
    assert bool(torch.isfinite(out["captured"][0][0]).all())
