"""The port's single-controller model held against the JAX package (CPU).

One shared Q-controller drives both ears (``SingleFrontend``). JAX
parameters are initialised from a seed and carried over with
``state_dict_from_jax`` (strict load); the same numpy inputs go through
both sides in eval mode, or with injected dropout masks. Tolerances are
those of tests/test_torch_port_model.py: outputs 2e-3 (f32) and 2e-2
(bf16), Q 5e-3; the filterbank gradient 5e-5 (f32) and 2e-2 (bf16), as
in tests/test_ops.py.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biear_tpu.models import BiEARConfig as JaxConfig
from biear_tpu.models import active_forward
from biear_tpu.models import frontend as jfe
from biear_tpu.models.biear import init_active
from biear_tpu.ops import filterbank as jfb
from biear_tpu.train.state import to_torch_state_dict
from biear_tpu.utils import torch_import as ti

from biear_tpu_torch.models import ActiveBiEAR, BiEARConfig, build_active
from biear_tpu_torch.models import frontend as tfe
from biear_tpu_torch.models.weights import state_dict_from_jax
from biear_tpu_torch.ops import erb as terb
from biear_tpu_torch.ops import filterbank as tfb
from biear_tpu_torch.serve import infer as tinfer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "protocol_r3", "singlectrl", "best.pth")
# conf/config_single_ctrl.yaml: absolute deltaQ, base 2.0, low 0.5, high 5
SINGLE = dict(controller_mode="single", deltaQ_mode="absolute",
              deltaQ_base=2.0, deltaQ_low_factor=0.5, deltaQ_high_factor=5.0)
SMALL = dict(SINGLE, fs=1600, timesteps=5, n_fft=256, n_bands=24, fmin=50.0,
             fmax=700.0, latent_dim=16, ctrl_hidden=16)
B = 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(kw, seed=0, perturb=True):
    """(jax cfg, jax params, port model) with the same weights; the
    controller's output layer perturbed so Q really adapts."""
    cfg_j, cfg_t = JaxConfig(**kw), BiEARConfig(**kw)
    params = init_active(jax.random.PRNGKey(seed), cfg_j)
    if perturb and not kw.get("fixed_frontend_q", False):
        rng = np.random.default_rng(seed)
        l3 = params["bifb"]["ctrl"]["q_out"]["l3"]
        for k in ("w", "b"):
            l3[k] = jnp.asarray(rng.uniform(-0.05, 0.05, l3[k].shape),
                                jnp.float32)
    model = ActiveBiEAR(cfg_t)
    model.load_state_dict(state_dict_from_jax(_np_tree(params), cfg_t),
                          strict=True)
    return cfg_j, params, model


def _wavs(seed, n):
    rng = np.random.default_rng(seed)
    wav = rng.uniform(-1, 1, (2, B, n)).astype(np.float32)
    return wav[0], wav[1], rng.uniform(-1, 1, (B, 100)).astype(np.float32)


def _close(got, want, tol, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=name)


# ---------------- weights and init ----------------

@pytest.mark.parametrize("kw", [SINGLE, dict(SINGLE, fixed_frontend_q=True)])
def test_state_dict_from_jax_matches_to_torch_state_dict(kw):
    cfg_j, cfg_t = JaxConfig(**kw), BiEARConfig(**kw)
    params = init_active(jax.random.PRNGKey(3), cfg_j)
    want = to_torch_state_dict(params, cfg_j)
    got = state_dict_from_jax(_np_tree(params), cfg_t)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    model = ActiveBiEAR(cfg_t)
    assert set(model.state_dict()) == set(want)
    model.load_state_dict(got, strict=True)
    if not kw.get("fixed_frontend_q"):
        assert "bifb.q_rnn.weight_ih_l0" in want
        assert want["bifb.q_rnn.weight_ih_l0"].shape == (3 * 128, 400)


def test_seeded_init_starts_at_q0():
    cfg = BiEARConfig(**SMALL)
    model = build_active(cfg, seed=5, device="cpu")
    sd = model.state_dict()
    assert torch.count_nonzero(sd["bifb.q_out.8.weight"]) == 0
    assert torch.count_nonzero(sd["bifb.q_out.8.bias"]) == 0
    assert model.bifb.controllers() == [model.bifb]
    w = torch.tensor(np.random.default_rng(5).uniform(-1, 1, (B, cfg.fs)),
                     dtype=torch.float32)
    with torch.no_grad():
        QL = model(w, w)[3]["QL"]
    Q0 = tfe.device_constants(cfg, "cpu")["Q0"]
    torch.testing.assert_close(QL, Q0.expand_as(QL), rtol=0, atol=0)


# ---------------- frontend and active_forward ----------------

@pytest.mark.parametrize("kw,tol", [
    (SMALL, 2e-3), (dict(SMALL, fb_w_dtype="bfloat16"), 2e-2),
    (dict(SMALL, freeze_q=True), 2e-3),
    (dict(SMALL, fixed_frontend_q=True), 2e-3),
    (SINGLE, 2e-3), (dict(SINGLE, fb_w_dtype="bfloat16"), 2e-2),
])
def test_single_frontend_matches_jax(kw, tol):
    cfg_j, params, model = _pair(kw, seed=4)
    wavL, wavR, _ = _wavs(4, cfg_j.fs)
    with jax.default_matmul_precision("highest"):
        want = jfe.single_frontend(params["bifb"], cfg_j, jnp.asarray(wavL),
                                   jnp.asarray(wavR), None, False)
    with torch.no_grad():
        got = model.bifb(_t(wavL), _t(wavR))
    names = ("YL", "YR", "QL", "QR", "phaseL", "phaseR")
    for name, g, w in zip(names, got, want):
        assert g.shape == (B, cfg_j.timesteps, cfg_j.n_bands), name
        if name.startswith("phase"):
            # angles on the circle; bands near the |Z| floor carry none
            d = np.angle(np.exp(1j * (g.numpy() - np.asarray(w))))
            assert np.mean(np.abs(d) < 10 * tol) > 0.99, name
        else:
            _close(g.numpy(), w, tol, name)
    np.testing.assert_array_equal(got[2].numpy(), got[3].numpy())
    q = got[2].numpy()
    moves = np.abs(q[:, 1:] - q[:, :1]).max()
    if kw.get("freeze_q") or kw.get("fixed_frontend_q"):
        assert moves == 0.0
    else:
        assert moves > 1e-4


@pytest.mark.parametrize("kw,tol", [
    (SMALL, 2e-3), (SINGLE, 2e-3),
    (dict(SINGLE, fb_w_dtype="bfloat16"), 2e-2),
    (dict(SINGLE, freeze_q=True), 2e-3),
])
def test_active_forward_matches_jax(kw, tol):
    cfg_j, params, model = _pair(kw, seed=6)
    wavL, wavR, x3 = _wavs(6, cfg_j.fs)
    x3 = x3[:, :cfg_j.n_bands]
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, a, b, c: active_forward(
            p, cfg_j, a, b, c, train=False))(
            params, jnp.asarray(wavL), jnp.asarray(wavR), jnp.asarray(x3))
    with torch.no_grad():
        got = model(_t(wavL), _t(wavR), _t(x3))
    for name, g, w in zip(("sound", "aoa", "dist"), got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=1e-3, err_msg=name)
    np.testing.assert_allclose(got[3]["Q"].numpy(), np.asarray(want[3]["Q"]),
                               atol=max(5e-3, tol), rtol=tol)


def test_single_frame_with_dropout_masks_matches_jax():
    """One frame of the shared controller with injected dropout masks
    (T, 2, B, H per forward: one controller, two sites) against JAX's
    scan body, carry included (the persistent EMA memories)."""
    kw = dict(SMALL, ctrl_dropout=0.3)
    cfg_j, params, model = _pair(kw, seed=7)
    cfg = model.cfg
    rng = np.random.default_rng(7)
    N, H, F = cfg.n_bands, cfg.ctrl_hidden, cfg.n_freq
    c = tfe.device_constants(cfg, "cpu")
    Q = (c["Q0"].numpy()[None] * rng.uniform(0.8, 1.2, (B, N))).astype(
        np.float32)
    h = rng.standard_normal((B, H)).astype(np.float32)
    memL, memR = (rng.uniform(0, 1, (B, N)).astype(np.float32)
                  for _ in range(2))
    spec = {e: [np.abs(x).astype(np.float32), x.real.astype(np.float32),
                x.imag.astype(np.float32)]
            for e, x in (("L", rng.standard_normal((B, F))
                          + 1j * rng.standard_normal((B, F))),
                         ("R", rng.standard_normal((B, F))
                          + 1j * rng.standard_normal((B, F))))}
    drops = rng.uniform(size=(2, B, H)) < 0.7
    assert model.bifb.mask_shape(B) == drops.shape
    with jax.default_matmul_precision("highest"):
        carry_j, out_j = jfe._single_step_rhs(
            params["bifb"]["ctrl"], cfg_j,
            tuple(jnp.asarray(a) for a in (Q, h, memL, memR)),
            jfb.stack_rhs(*(jnp.asarray(a) for a in spec["L"])),
            jfb.stack_rhs(*(jnp.asarray(a) for a in spec["R"])),
            train=True, drops=jnp.asarray(drops))
    rhs = torch.cat([tfb.stack_rhs(*(_t(a) for a in spec[e]))
                     for e in "LR"])
    with torch.no_grad():
        carry_t, (Y, Qo, ph) = model.bifb.frame(
            c, model.bifb.filterbank(c), tuple(_t(a) for a in
                                               (Q, h, memL, memR)),
            rhs, _t(drops))
        carry_0, _ = model.bifb.frame(
            c, model.bifb.filterbank(c), tuple(_t(a) for a in
                                               (Q, h, memL, memR)), rhs)
    for name, g, w in zip(("Q", "h", "memL", "memR"), carry_t, carry_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    YL, YR, Qj, _, _ = out_j
    np.testing.assert_allclose(Y[0].numpy(), np.asarray(YL), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(Y[1].numpy(), np.asarray(YR), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(Qo[0].numpy(), Q)
    assert float((carry_t[0] - carry_0[0]).abs().max()) > 1e-4  # masks acted


# ---------------- the (2B) filterbank call's Q gradient ----------------

@pytest.mark.parametrize("vjp", ["custom", "autodiff"])
@pytest.mark.parametrize("bf16,tol", [(False, 5e-5), (True, 2e-2)])
def test_q_gradient_of_the_2b_call_sums_both_ears(vjp, bf16, tol):
    """Both ears in one (2B) filterbank call with Q repeated: the Q
    gradient is the sum over the ears, equal to JAX's two calls."""
    rng = np.random.default_rng(13)
    N, F = 100, 513
    fc, Q0 = terb.erb_spaced_fc_and_q(N, 50.0, 7200.0)
    f_fft = np.linspace(0, 8000.0, F).astype(np.float32)
    Q = (Q0[None] * rng.uniform(0.7, 1.4, (B, N))).astype(np.float32)
    spec = []
    for _ in range(2):
        X = rng.standard_normal((B, F)) + 1j * rng.standard_normal((B, F))
        spec.append([np.abs(X).astype(np.float32), X.real.astype(np.float32),
                     X.imag.astype(np.float32)])
    co = rng.standard_normal((3, 2 * B, N)).astype(np.float32)
    wdt = jnp.bfloat16 if bf16 else None

    def jax_loss(q):
        total = 0.0
        for e in range(2):
            rhs = jfb.stack_rhs(*(jnp.asarray(a) for a in spec[e]), wdt)
            out = jfb.filterbank_apply_rhs(q, jnp.asarray(fc),
                                           jnp.asarray(f_fft), rhs, wdt,
                                           vjp=vjp, x_grad=False)
            total = total + sum(jnp.sum(o * c[e * B:(e + 1) * B])
                                for o, c in zip(out, co))
        return total

    with jax.default_matmul_precision("highest"):
        gj = np.asarray(jax.grad(jax_loss)(jnp.asarray(Q)))
    q = _t(Q).requires_grad_()
    rhs = torch.cat([tfb.stack_rhs(*(_t(a) for a in s), bf16) for s in spec])
    out = tfb.filterbank_apply_rhs(torch.cat([q, q]), _t(fc), _t(f_fft), rhs,
                                   bf16, vjp, x_grad=False)
    loss = sum((o * _t(c)).sum() for o, c in zip(out, co))
    gt = torch.autograd.grad(loss, q)[0].numpy()
    np.testing.assert_allclose(gt, gj, rtol=tol, atol=tol * 1e-1 *
                               np.abs(gj).max())
    # the sum of both ears, not one ear
    q1 = _t(Q).requires_grad_()
    out1 = tfb.filterbank_apply_rhs(q1, _t(fc), _t(f_fft), rhs[:B], bf16,
                                    vjp, x_grad=False)
    g1 = torch.autograd.grad(sum((o * _t(c[:B])).sum()
                                 for o, c in zip(out1, co)), q1)[0]
    assert float((torch.from_numpy(gt) - g1).abs().max()) > 1e-3


# ---------------- the reference checkpoint, serving ----------------

def _reference_settings():
    with open(os.path.join(os.path.dirname(CKPT), "settings.json")) as f:
        return json.load(f)


def test_reference_checkpoint_loads_strict_and_matches_jax():
    """docs/protocol_r3/singlectrl/best.pth (absolute deltaQ, base 2, bf16
    filterbank operands, rFFT spectra) through JAX import_active +
    active_forward and through the port's load_model + forward."""
    from biear_tpu.config import config_from_settings as jax_config

    settings = _reference_settings()
    cfg_t = tinfer.config_from_settings(settings)
    cfg_j = jax_config(settings)[0]
    assert cfg_t.controller_mode == "single" and not cfg_t.use_dft_matmul
    assert cfg_t.fb_w_dtype == "bfloat16"
    model = tinfer.load_model(CKPT, cfg_t, device="cpu")
    sd = tinfer.load_state_dict(CKPT)
    assert set(model.state_dict()) <= set(sd)
    model.load_state_dict({k: v for k, v in sd.items()
                           if k in model.state_dict()}, strict=True)
    params = ti.import_active(ti.load_state_dict(CKPT), cfg_j)
    wavL, wavR, x3 = _wavs(21, 16000)
    with jax.default_matmul_precision("highest"):
        want = active_forward(params, cfg_j, jnp.asarray(wavL),
                              jnp.asarray(wavR), jnp.asarray(x3),
                              train=False)
    with torch.no_grad():
        got = model(_t(wavL), _t(wavR), _t(x3))
    for name, g, w in zip(("sound", "aoa", "dist"), got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-2,
                                   rtol=1e-3, err_msg=name)
    q = got[3]["Q"].numpy()
    assert np.abs(q[:, 1:] - q[:, :1]).max() > 1e-3     # trained Q moves


def test_cli_serves_the_reference_checkpoint(tmp_path, capsys):
    """The serving CLI on the CPU, the checkpoint laid out with
    meta/settings.json, against predict on the same weights."""
    from scipy.io import wavfile

    run = tmp_path / "run"
    (run / "meta").mkdir(parents=True)
    shutil.copy(CKPT, run / "best.pth")
    (run / "meta" / "settings.json").write_text(
        json.dumps(_reference_settings()))
    wavL, wavR, _ = _wavs(22, 16000)
    paths = []
    for i in range(B):
        p = tmp_path / f"u{i}.wav"
        wavfile.write(p, 16000, (np.stack([wavL[i], wavR[i]], 1)
                                 * 20000).astype(np.int16))
        paths.append(str(p))
    tinfer.main(["--checkpoint", str(run / "best.pth"), "--device", "cpu",
                 *paths])
    recs = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    model = tinfer.load_model(CKPT, tinfer.config_from_settings(
        _reference_settings()), device="cpu")
    pairs = [tinfer.read_stereo_wav(p, 16000) for p in paths]
    probs, aoa, distp = tinfer.predict(model, np.stack([a for a, _ in pairs]),
                                       np.stack([b for _, b in pairs]))
    assert probs.shape == (B, 8) and distp.shape == (B, 8, 5)
    for r, pr in zip(recs, probs.numpy()):
        np.testing.assert_allclose([s["present"] for s in r["sectors"]],
                                   pr, atol=1e-4)
