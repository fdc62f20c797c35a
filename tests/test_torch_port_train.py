"""The PyTorch port's training path held against the JAX package (CPU).

The same numpy inputs, made from a seed, go through each JAX function and
its port. Tolerances are the JAX package's own for the same ops: the
filterbank backward at 5e-5 (f32) and 2e-2 (bf16) as in
tests/test_ops.py; the 3-step training trajectory at loss 5e-5 and
parameters 3e-3, the bounds tests/test_torch_trajectory.py holds the JAX
step to against the PyTorch reference. Random streams differ between the
frameworks, so dropout is either off or fed the same masks.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biear_tpu.models import BiEARConfig as JaxConfig
from biear_tpu.models import frontend as jfe
from biear_tpu.models.biear import init_active
from biear_tpu.ops import filterbank as jfb
from biear_tpu.train import loop as jloop
from biear_tpu.train import losses as jlo
from biear_tpu.train import optim as jopt

from biear_tpu_torch.kernels import LAUNCHES
from biear_tpu_torch.models import ActiveBiEAR, BiEARConfig
from biear_tpu_torch.models import controller as tctrl
from biear_tpu_torch.models import frontend as tfe
from biear_tpu_torch.models import layers as tla
from biear_tpu_torch.models.weights import state_dict_from_jax
from biear_tpu_torch.ops import erb as terb
from biear_tpu_torch.ops import filterbank as tfb
from biear_tpu_torch.train import loop as tloop
from biear_tpu_torch.train import losses as tlo
from biear_tpu_torch.train import optim as topt

TINY = dict(fs=1600, timesteps=4, n_fft=256, n_bands=24, fmin=50.0,
            fmax=700.0, latent_dim=24, deltaQ_mode="relative")


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _fake_targets(rng, B):
    """Random but structurally valid y (B, 56)."""
    y = np.zeros((B, 8, 7), np.float32)
    y[:, :, 2] = 1.0
    for b in range(B):
        for s in rng.choice(8, size=rng.integers(1, 4), replace=False):
            y[b, s, 0] = 1.0
            y[b, s, 1] = rng.uniform(0, 1)
            y[b, s, 2:] = 0.0
            y[b, s, 2 + rng.integers(1, 5)] = 1.0
    return y.reshape(B, 56)


def _batch(rng, cfg, B=4):
    wav = rng.uniform(-1, 1, (2, B, cfg.fs)).astype(np.float32)
    x3 = rng.uniform(-1, 1, (B, cfg.n_bands)).astype(np.float32)
    return wav[0], wav[1], x3, _fake_targets(rng, B)


def _pair(kw, seed=0):
    """(jax cfg, jax params, port model) with the same weights."""
    cfg_j, cfg_t = JaxConfig(**kw), BiEARConfig(**kw)
    params = init_active(jax.random.PRNGKey(seed), cfg_j)
    model = ActiveBiEAR(cfg_t)
    model.load_state_dict(state_dict_from_jax(_np_tree(params), cfg_t),
                          strict=True)
    return cfg_j, params, model


# ---------------- filterbank backward ----------------

def _fb_inputs(seed, B=3, N=100, F=513):
    rng = np.random.default_rng(seed)
    fc, Q0 = terb.erb_spaced_fc_and_q(N, 50.0, 7200.0)
    f_fft = np.linspace(0, 8000.0, F).astype(np.float32)
    Q = (Q0[None] * rng.uniform(0.7, 1.4, (B, N))).astype(np.float32)
    X = rng.standard_normal((B, F)) + 1j * rng.standard_normal((B, F))
    spec = [np.abs(X).astype(np.float32), X.real.astype(np.float32),
            X.imag.astype(np.float32)]
    co = [rng.standard_normal((B, N)).astype(np.float32) for _ in range(3)]
    return Q, fc, f_fft, spec, co


@pytest.mark.parametrize("mode,tol", [("f32", 5e-5), ("bf16", 2e-2),
                                      ("f32|noxg", 5e-5),
                                      ("bf16|noxg", 2e-2)])
def test_filterbank_fn_matches_jax_custom_vjp(mode, tol):
    Q, fc, f_fft, spec, co = _fb_inputs(11)
    bf16 = mode.startswith("bf16")
    x_grad = not mode.endswith("|noxg")

    def jax_loss(q, xm, xr, xi):
        rhs = jfb.stack_rhs(xm, xr, xi, jnp.bfloat16 if bf16 else None)
        Y, Zre, Zim = jfb._fb_apply_rhs(q, jnp.asarray(fc),
                                        jnp.asarray(f_fft), rhs, mode)
        return jnp.sum(Y * co[0] + Zre * co[1] + Zim * co[2]), (Y, Zre, Zim)

    (_, want), gj = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3),
                                       has_aux=True)(
        jnp.asarray(Q), *(jnp.asarray(s) for s in spec))

    q = _t(Q).requires_grad_()
    xs = [_t(s).requires_grad_() for s in spec]
    rhs = tfb.stack_rhs(*xs, bf16)
    got = tfb.FilterbankFn.apply(q, rhs, _t(fc), _t(f_fft), mode)
    plain = tfb.fb_forward(q, _t(fc), _t(f_fft), rhs, bf16)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g.detach().numpy(), p.detach().numpy())
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=tol, atol=tol * 1e-1)
    loss = sum((o * _t(c)).sum() for o, c in zip(got, co))
    gt = torch.autograd.grad(loss, [q, *xs])
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol * 1e-1)
    if not x_grad:
        for g in gt[1:]:
            np.testing.assert_array_equal(g.numpy(), 0.0)
    else:
        assert all(float(g.abs().max()) > 0 for g in gt[1:])


@pytest.mark.parametrize("bf16,tol", [(False, 5e-5), (True, 2e-2)])
def test_filterbank_fn_matches_port_autograd(bf16, tol):
    """The hand backward against plain autograd through fb_forward."""
    Q, fc, f_fft, spec, co = _fb_inputs(12, N=64, F=257)
    grads = []
    for custom in (True, False):
        q = _t(Q).requires_grad_()
        xs = [_t(s).requires_grad_() for s in spec]
        vjp = "custom" if custom else "autodiff"
        out = tfb.filterbank_apply_rhs(q, _t(fc), _t(f_fft),
                                       tfb.stack_rhs(*xs, bf16), bf16, vjp)
        loss = sum((o * _t(c)).sum() for o, c in zip(out, co))
        grads.append(torch.autograd.grad(loss, [q, *xs]))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol,
                                   atol=tol * 1e-1)


def test_resolve_fb_vjp(monkeypatch):
    """Explicit choices pass through as in JAX; "auto" is the hand backward
    at every batch, and no environment variable changes the choice."""
    monkeypatch.delenv("BIEAR_FB_VJP", raising=False)
    for vjp in ("custom", "autodiff"):
        assert tfb.resolve_fb_vjp(vjp) == jfb.resolve_fb_vjp(vjp, 4) == vjp
    monkeypatch.setenv("BIEAR_FB_VJP", "autodiff")
    assert tfb.resolve_fb_vjp("custom") == "custom"
    assert tfb.resolve_fb_vjp("auto") == "custom"
    with pytest.raises(ValueError, match="fb_vjp"):
        tfb.resolve_fb_vjp("fast")


# ---------------- dropout and the controller step ----------------

def test_dropout_masks_from_a_generator():
    gen = torch.Generator().manual_seed(3)
    m = tla.dropout_masks(gen, 0.25, (200, 300))
    assert m.dtype == torch.bool and abs(float(m.float().mean()) - 0.75) < 0.01
    x = torch.ones(200, 300)
    y = tla.dropout_apply(m, x, 0.25)
    np.testing.assert_array_equal(y[m].numpy(),
                                  np.float32(1.0) / np.float32(0.75))
    np.testing.assert_array_equal(y[~m].numpy(), 0.0)
    assert tla.dropout(None, x, 0.25, deterministic=True) is x
    assert tla.dropout(gen, x, 0.0, deterministic=False) is x
    a = tla.dropout(torch.Generator().manual_seed(5), x, 0.5, False)
    b = tla.dropout(torch.Generator().manual_seed(5), x, 0.5, False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_controller_step_with_masks_matches_jax():
    kw = dict(TINY, ctrl_dropout=0.3)
    cfg_j, params, model = _pair(kw, seed=2)
    rng = np.random.default_rng(2)
    B, H = 5, cfg_j.ctrl_hidden
    h = rng.standard_normal((B, H)).astype(np.float32)
    feat = rng.standard_normal((B, 2 * cfg_j.n_bands)).astype(np.float32)
    drops = rng.uniform(size=(2, B, H)) < 0.7
    p = jax.tree.map(lambda a: a[1], params["bifb"]["fb"])   # right ear
    # a non-zero output layer, so the masks reach delta
    l3 = rng.uniform(-0.5, 0.5, (cfg_j.n_bands, H)).astype(np.float32)
    p["q_out"]["l3"]["w"] = jnp.asarray(l3)
    with torch.no_grad():
        model.bifb.fb_R.q_out[8].weight.copy_(_t(l3))
    with jax.default_matmul_precision("highest"):
        dj, hj = jfe.controller_step(p, cfg_j, jnp.asarray(h),
                                     jnp.asarray(feat), None, True,
                                     drops=jnp.asarray(drops))
    c = tfe.device_constants(model.cfg, "cpu")
    p_t = tctrl.controller_params(model.bifb.fb_R)
    with torch.no_grad():
        _, ht, saved = tctrl.controller_step(model.cfg, c, _t(h), _t(feat),
                                             _t(drops), p_t)
        d0 = tctrl.controller_step(model.cfg, c, _t(h), _t(feat), None,
                                   p_t)[2].delta
    dt = saved.delta
    # f32 sums in another order through two LayerNorms: a few ulps of O(1)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-5)
    assert float((dt - d0).abs().max()) > 1e-3      # the masks did act


def test_training_forward_draws_dropout_from_the_generator():
    cfg = BiEARConfig(**TINY, ctrl_dropout=0.2, backend_dropout=0.3)
    model = ActiveBiEAR(cfg).init_weights_(0)
    rng = np.random.default_rng(0)
    wl, wr, x3, _ = _batch(rng, cfg, B=3)
    with torch.no_grad():
        ev = model(_t(wl), _t(wr), _t(x3))[0]
    model.train()

    def run(seed):
        with torch.no_grad():
            return model(_t(wl), _t(wr), _t(x3),
                         gen=torch.Generator().manual_seed(seed))[0]

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert float((run(1) - run(2)).abs().max()) > 1e-4
    assert float((run(1) - ev).abs().max()) > 1e-4


# ---------------- losses, telemetry, scheduler ----------------

@pytest.mark.parametrize("weighted", [False, True])
def test_losses_and_q_regularizers_match_jax(weighted):
    rng = np.random.default_rng(5)
    B = 6
    y = _fake_targets(rng, B)
    s = rng.standard_normal((B, 8)).astype(np.float32) * 3
    a = rng.uniform(0, 1, (B, 8)).astype(np.float32)
    d = rng.standard_normal((B, 8, 5)).astype(np.float32)
    Q = rng.uniform(0.5, 9.0, (B, 4, 24)).astype(np.float32)
    Q0 = rng.uniform(1.0, 8.0, 24).astype(np.float32)
    w = np.array([1, 1, 0, 1, 0, 1], np.float32) if weighted else None
    wj = None if w is None else jnp.asarray(w)
    wt = None if w is None else _t(w)
    lj, mj = jlo.task_loss(*(jnp.asarray(v) for v in (s, a, d, y)), w=wj)
    lt, mt = tlo.task_loss(*(_t(v) for v in (s, a, d, y)), w=wt)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-6,
                                   err_msg=k)
    rj = jlo.q_regularizers(jnp.asarray(Q), jnp.asarray(Q0), 1e-3, 2e-3, wj)
    rt = tlo.q_regularizers(_t(Q), _t(Q0), 1e-3, 2e-3, wt)
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-6)
    ys, ya, yd = tlo.unpack_targets(_t(y))
    for k in range(8):
        np.testing.assert_array_equal(ys[:, k].numpy(), y[:, 7 * k])
        np.testing.assert_array_equal(yd[:, k].numpy(),
                                      y[:, 7 * k + 2:7 * k + 7])
    if weighted:       # zero-weight rows count for nothing
        keep = w > 0
        lk, _ = tlo.task_loss(*(_t(v[keep]) for v in (s, a, d, y)))
        np.testing.assert_allclose(float(lt), float(lk), rtol=1e-6)


def test_group_norms_and_histograms_match_jax():
    rng = np.random.default_rng(6)
    shapes = {"bifb.fb_L.q_rnn.weight_hh_l0": (6, 4), "bifb.fb_R.x": (3,),
              "body.0.weight": (5, 7), "cc_proj.bias": (9,),
              "subheads.0.sound.4.weight": (1, 10)}
    grads = {k: (rng.standard_normal(s)
                 * 10.0 ** rng.uniform(-13, 5, s)).astype(np.float32)
             for k, s in shapes.items()}
    grads["cc_proj.bias"][:3] = 0.0
    tree = {"bifb": {k: grads[k] for k in grads if k.startswith("bifb.")},
            **{k: grads[k] for k in grads if not k.startswith("bifb.")}}
    want = jloop._group_norms(jax.tree.map(jnp.asarray, tree))
    got = tloop.group_norms({k: _t(v) for k, v in grads.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    leaves = list(grads.values())
    hj = jloop._grad_histograms([jnp.asarray(g) for g in leaves], 4)
    ht = tloop.grad_histograms({k: _t(v) for k, v in grads.items()}, 4)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(tloop.GRAD_HIST_EDGES,
                                  jloop.GRAD_HIST_EDGES)


def test_plateau_scheduler_matches_jax():
    vals = [1.0, 0.9, 0.91, 0.91, 0.91, float("nan"), 0.5, 0.5, 0.5, 0.5,
            0.49999, 0.2]
    sj = jopt.PlateauScheduler(factor=0.5, patience=2)
    st = topt.PlateauScheduler(factor=0.5, patience=2)
    assert [st.step(v) for v in vals] == [sj.step(v) for v in vals]


def test_train_hyper_is_a_copy():
    assert (dataclasses.asdict(topt.TrainHyper())
            == dataclasses.asdict(jopt.TrainHyper()))


# ---------------- optimizer groups ----------------

def test_optimizer_groups_and_branches():
    hp = topt.TrainHyper()
    model = ActiveBiEAR(BiEARConfig(**TINY)).init_weights_(0)
    opt = topt.make_optimizer(model, hp)
    assert [(g.label, g.lr, g.clip) for g in opt.groups] == [
        ("frontend", hp.lr_fb, hp.clip_fb),
        ("backend", hp.lr_backend, hp.clip_backend)]
    assert all(n.startswith("bifb.") for n in opt.groups[0].names)
    assert not any(n.startswith("bifb.") for n in opt.groups[1].names)
    fixed = ActiveBiEAR(BiEARConfig(**TINY, fixed_frontend_q=True))
    one = topt.make_optimizer(fixed, hp)
    assert [(g.label, g.clip) for g in one.groups] == [
        ("backend", hp.grad_clip_norm)]
    frz = topt.make_optimizer(model, hp, freeze_controller=True)
    assert [(g.label, g.frozen) for g in frz.groups] == [
        ("frozen", True), ("backend", False)]
    assert frz.groups[1].clip == hp.grad_clip_norm


def test_freeze_controller_trains_only_the_backend():
    cfg = BiEARConfig(**TINY, ctrl_dropout=0.0, backend_dropout=0.0)
    model = ActiveBiEAR(cfg).init_weights_(1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    hp = topt.TrainHyper()
    opt = topt.make_optimizer(model, hp, freeze_controller=True)
    batch = tuple(_t(a) for a in _batch(np.random.default_rng(1), cfg))
    m = tloop.train_step(model, hp, opt, batch, torch.Generator())
    assert float(m["skipped"]) == 0.0 and float(m["grad_fb_norm"]) > 0
    for k, v in model.state_dict().items():
        moved = not torch.equal(v, before[k])
        assert moved == (not k.startswith("bifb.")), k


# ---------------- train step: trajectory and masked skip ----------------

def _jax_trajectory(cfg_j, params, hp, batches):
    opt = jopt.make_optimizer(params, hp)
    state = opt.init(params)
    step = jloop.make_train_step(cfg_j, hp, opt, "active")
    params = jax.tree.map(jnp.copy, params)
    losses = []
    with jax.default_matmul_precision("highest"):
        for i, b in enumerate(batches):
            params, state, m = step(params, state,
                                    tuple(jnp.asarray(a) for a in b),
                                    jax.random.PRNGKey(i), jnp.float32(1.0))
            losses.append(float(m["loss"]))
            assert float(m["skipped"]) == 0.0
    return losses, params


@pytest.mark.parametrize("controller_mode,fb_vjp,fb_w_dtype", [
    ("dual", "autodiff", "float32"), ("dual", "custom", "float32"),
    ("single", "autodiff", "float32"), ("single", "custom", "float32"),
    ("dual", "custom", "bfloat16"), ("single", "custom", "bfloat16")],
    ids=["autodiff", "custom", "single-autodiff", "single-custom",
         "custom-bf16-noxg", "single-custom-bf16-noxg"])
def test_three_step_trajectory_matches_jax(controller_mode, fb_vjp,
                                           fb_w_dtype):
    """Three steps against JAX's; "custom-bf16-noxg" is the production
    policy (bf16 filterbank operands, no spectra gradient), whose dual
    and single frontends train through models/frontend_bwd.py's
    recurrence."""
    kw = dict(TINY, ctrl_dropout=0.0, backend_dropout=0.0, fb_vjp=fb_vjp,
              controller_mode=controller_mode, fb_w_dtype=fb_w_dtype)
    cfg_j, params, model = _pair(kw, seed=0)
    rng = np.random.default_rng(10)
    batches = [_batch(rng, cfg_j) for _ in range(3)]
    hp = topt.TrainHyper()
    losses_j, params_j = _jax_trajectory(cfg_j, params, hp, batches)

    opt = topt.make_optimizer(model, hp)
    step = tloop.make_train_step(model, hp, opt)
    gen = torch.Generator()
    losses_t = []
    for b in batches:
        m = step(tuple(_t(a) for a in b), gen)
        assert float(m["skipped"]) == 0.0
        losses_t.append(float(m["loss"]))
    d = np.abs(np.array(losses_t) - np.array(losses_j))
    assert d.max() < 5e-5, (losses_t, losses_j)
    want = state_dict_from_jax(_np_tree(params_j), model.cfg)
    got = model.state_dict()
    diffs = {k: float((got[k] - want[k]).abs().max()) for k in want}
    assert max(diffs.values()) < 3e-3, sorted(diffs.items(),
                                              key=lambda kv: -kv[1])[:5]
    assert all(int(g.count) == 3 for g in opt.groups)
    # Q left its start: the controllers really trained
    out_layer = ("bifb.q_out.8.weight" if controller_mode == "single"
                 else "bifb.fb_L.q_out.8.weight")
    assert diffs and float(got[out_layer].abs().max()) > 0


def test_poisoned_batch_leaves_params_and_adam_state_bit_identical():
    cfg = BiEARConfig(**TINY, ctrl_dropout=0.1, backend_dropout=0.2)
    model = ActiveBiEAR(cfg).init_weights_(4)
    hp = topt.TrainHyper()
    opt = topt.make_optimizer(model, hp)
    rng = np.random.default_rng(4)
    gen = torch.Generator().manual_seed(0)
    good = tuple(_t(a) for a in _batch(rng, cfg))
    tloop.train_step(model, hp, opt, good, gen)        # non-zero moments

    def snapshot():
        return ([p.detach().clone() for p in model.parameters()],
                [[t.clone() for t in g.m + g.v] + [g.count.clone()]
                 for g in opt.groups])

    before = snapshot()
    wl, wr, x3, y = _batch(rng, cfg)
    y[:] = np.nan
    m = tloop.train_step(model, hp, opt, tuple(_t(a) for a in (wl, wr, x3, y)),
                         gen)
    assert float(m["skipped"]) == 1.0
    after = snapshot()
    for a, b in zip(before[0], after[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for ga, gb in zip(before[1], after[1]):
        for a, b in zip(ga, gb):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(int(g.count) == 1 for g in opt.groups)
    m = tloop.train_step(model, hp, opt, good, gen)    # and training goes on
    assert float(m["skipped"]) == 0.0
    assert all(int(g.count) == 2 for g in opt.groups)


def test_eval_step_matches_jax():
    cfg_j, params, model = _pair(dict(TINY), seed=3)
    b = _batch(np.random.default_rng(3), cfg_j)
    hp = topt.TrainHyper()
    with jax.default_matmul_precision("highest"):
        mj = jloop.make_eval_step(cfg_j, hp, "active")(
            params, tuple(jnp.asarray(a) for a in b))
    ev = tloop.make_eval_step(model, hp)
    mt = ev(tuple(_t(a) for a in b))
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), atol=2e-5,
                                   err_msg=k)
    assert float(ev(tuple(_t(a) for a in b))["loss"]) == float(mt["loss"])


def test_train_chunk_equals_the_steps_one_by_one():
    """The chunk with a generator == the same steps driven by hand with a
    generator in the same state (synthesis first, dropout second)."""
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    cfg = BiEARConfig(controller_mode="dual", deltaQ_mode="relative",
                      n_bands=16, latent_dim=16, ctrl_hidden=16,
                      timesteps=3, ctrl_dropout=0.1, backend_dropout=0.2)
    ir, az, dist = make_test_hrir_bank()
    synth = AnechoicSynthesizer(ir, az, dist, make_test_segments(6),
                                num_lags=cfg.n_bands, mix_dtype="bfloat16",
                                device="cpu")
    hp = topt.TrainHyper()
    runs = []
    for fused in (True, False):
        model = ActiveBiEAR(cfg).init_weights_(0)
        opt = topt.make_optimizer(model, hp)
        gen = torch.Generator().manual_seed(9)
        LAUNCHES.clear()
        if fused:
            ms = tloop.make_train_chunk(model, hp, opt, synth.batch_fn(2),
                                        2)(gen)
            assert ms["loss"].shape == (2,) and ms["skipped"].sum() == 0
            assert ms["grad_hist"].shape[0] == 2
        else:
            for _ in range(2):
                tloop.train_step(model, hp, opt, synth.sample_batch(gen, 2),
                                 gen)
        assert sum(LAUNCHES.values()) == 0      # CPU: plain versions only
        runs.append(model.state_dict())
    for k in runs[0]:
        torch.testing.assert_close(runs[0][k], runs[1][k], rtol=0, atol=0)
