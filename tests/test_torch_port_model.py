"""The PyTorch port's model and serving path held against the JAX package.

JAX parameters are initialised from a seed, carried over with
``state_dict_from_jax`` and loaded with ``strict=True``; the same numpy
waveforms go through both sides on the CPU in eval mode. Tolerances:
f32 policy at atol 2e-3 / rtol 1e-3 on the outputs and 5e-3 on Q
(tests/test_model_parity.py), bf16 policy at 2e-2.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biear_tpu.config import config_from_settings as jax_config_from_settings
from biear_tpu.models import BiEARConfig as JaxConfig
from biear_tpu.models import active_forward
from biear_tpu.models import backend as jbe
from biear_tpu.models import frontend as jfe
from biear_tpu.models import layers as jla
from biear_tpu.models.biear import init_active
from biear_tpu.ops.xcorr import cross_correlation_feature as jax_cc_feature
from biear_tpu.train import losses as jlo
from biear_tpu.train.state import to_torch_state_dict

from biear_tpu_torch.models import ActiveBiEAR, BiEARConfig, build_active
from biear_tpu_torch.models import backend as tbe
from biear_tpu_torch.models import controller as tctrl
from biear_tpu_torch.models import frontend as tfe
from biear_tpu_torch.models.layers import GRU
from biear_tpu_torch.models.weights import state_dict_from_jax
from biear_tpu_torch.serve import infer as tinfer
from biear_tpu_torch.train import losses as tlo

FLAGSHIP = dict(controller_mode="dual", deltaQ_mode="relative",
                deltaQ_base=1.0, deltaQ_low_factor=0.3, deltaQ_high_factor=5.0)
ABSOLUTE = dict(controller_mode="dual", deltaQ_mode="absolute",
                deltaQ_base=2.0, deltaQ_low_factor=0.5, deltaQ_high_factor=5.0)
B = 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb_controllers(params, seed: int):
    """Non-zero controller output layers, so Q really adapts."""
    rng = np.random.default_rng(seed)
    l3 = params["bifb"]["fb"]["q_out"]["l3"]
    l3["w"] = jnp.asarray(rng.uniform(-0.05, 0.05, l3["w"].shape), jnp.float32)
    l3["b"] = jnp.asarray(rng.uniform(-0.05, 0.05, l3["b"].shape), jnp.float32)
    return params


def _pair(kw, seed=0, perturb=True):
    """(jax cfg, jax params, port model) with the same weights."""
    cfg_j, cfg_t = JaxConfig(**kw), BiEARConfig(**kw)
    params = init_active(jax.random.PRNGKey(seed), cfg_j)
    if perturb and not kw.get("fixed_frontend_q", False):
        params = _perturb_controllers(params, seed)
    model = ActiveBiEAR(cfg_t)
    model.load_state_dict(state_dict_from_jax(_np_tree(params), cfg_t),
                          strict=True)
    return cfg_j, params, model


def _wavs(seed, n=16000):
    rng = np.random.default_rng(seed)
    wav = rng.uniform(-1, 1, (2, B, n)).astype(np.float32)
    x3 = rng.uniform(-1, 1, (B, 100)).astype(np.float32)
    return wav[0], wav[1], x3


# ---------------- weights ----------------

@pytest.mark.parametrize("kw", [FLAGSHIP, dict(FLAGSHIP, fixed_frontend_q=True),
                                dict(FLAGSHIP, use_cc=False)])
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


def test_seeded_init_is_deterministic_and_starts_at_q0():
    cfg = BiEARConfig(**FLAGSHIP)
    a = build_active(cfg, seed=5, device="cpu").state_dict()
    b = build_active(cfg, seed=5, device="cpu").state_dict()
    c = build_active(cfg, seed=6, device="cpu").state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    assert torch.count_nonzero(a["bifb.fb_L.q_out.8.weight"]) == 0
    assert torch.count_nonzero(a["bifb.fb_R.q_out.8.bias"]) == 0
    torch.testing.assert_close(a["encoder_ild.in_norm.weight"],
                               torch.ones(100), rtol=0, atol=0)
    bound = 1.0 / np.sqrt(200)
    assert float(a["body.0.weight"].abs().max()) <= 1.0 / np.sqrt(300)
    assert float(a["encoder_ipd.gru1.weight_hh_l0"].abs().max()) <= bound


# ---------------- layers, frontend, backend ----------------

def test_gru_sequence_and_step_match_jax():
    rng = np.random.default_rng(1)
    p = jla.gru_init(jax.random.PRNGKey(1), 12, 9)
    gru = GRU(12, 9)
    with torch.no_grad():
        for ours, theirs in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0"),
                             ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
            getattr(gru, theirs).copy_(_t(p[ours]))
    x = rng.standard_normal((3, 5, 12)).astype(np.float32)
    h = rng.standard_normal((3, 9)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        seq_j, last_j = jla.gru_seq(p, jnp.asarray(x))
        step_j = jla.gru_step(p, jnp.asarray(h), jnp.asarray(x[:, 0]))
    with torch.no_grad():
        seq_t, last_t = gru(_t(x))
        step_t = gru.step(_t(x[:, 0]), _t(h))
    np.testing.assert_allclose(seq_t.numpy(), np.asarray(seq_j), atol=1e-5)
    np.testing.assert_allclose(last_t[0].numpy(), np.asarray(last_j), atol=1e-5)
    np.testing.assert_allclose(step_t.numpy(), np.asarray(step_j), atol=1e-5)


@pytest.mark.parametrize("kw", [FLAGSHIP, ABSOLUTE])
def test_controller_step_and_next_q_match_jax(kw):
    cfg_j, params, model = _pair(kw, seed=2)
    ctrl_j = jax.tree.map(lambda a: a[0], params["bifb"]["fb"])
    rng = np.random.default_rng(2)
    feat = rng.standard_normal((B, 200)).astype(np.float32)
    h = rng.standard_normal((B, 128)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        d_j, h_j = jfe.controller_step(ctrl_j, cfg_j, jnp.asarray(h),
                                       jnp.asarray(feat), None, False)
        q_j = jfe._next_q(cfg_j, jfe.frontend_constants(cfg_j), d_j)
    with torch.no_grad():
        c = tfe.device_constants(model.cfg, "cpu")
        q_t, h_t, saved = tctrl.controller_step(
            model.cfg, c, _t(h), _t(feat), None,
            tctrl.controller_params(model.bifb.fb_L))
    assert bool(saved.ok)
    np.testing.assert_allclose(saved.delta.numpy(), np.asarray(d_j),
                               atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-5)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-5)
    assert float(np.abs(np.asarray(d_j)).max()) > 1e-3


def test_finite_reset_is_whole_batch():
    """A nonfinite input row makes that row's next Q nonfinite: the step
    resets Q to Q0 and h to zeros for the whole batch, as JAX's
    _finite_reset does; without that row nothing is reset."""
    cfg_j, params, model = _pair(FLAGSHIP, seed=3)
    ctrl_j = jax.tree.map(lambda a: a[1], params["bifb"]["fb"])
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((B, 200)).astype(np.float32)
    feat[1, 5] = np.nan
    h = rng.standard_normal((B, 128)).astype(np.float32)
    c_j = jfe.frontend_constants(cfg_j)
    c = tfe.device_constants(model.cfg, "cpu")
    p = tctrl.controller_params(model.bifb.fb_R)

    def jax_step(rows):
        with jax.default_matmul_precision("highest"):
            d_j, h_j = jfe.controller_step(ctrl_j, cfg_j,
                                           jnp.asarray(h[rows]),
                                           jnp.asarray(feat[rows]), None,
                                           False)
            return jfe._finite_reset(jfe._next_q(cfg_j, c_j, d_j), h_j,
                                     jnp.asarray(c_j["Q0"])[None])
    with torch.no_grad():
        Qr, hr, saved = tctrl.controller_step(model.cfg, c, _t(h), _t(feat),
                                              None, p)
        Qk, hk, kept = tctrl.controller_step(model.cfg, c, _t(h[:1]),
                                             _t(feat[:1]), None, p)
    Qj, hj = jax_step(slice(None))
    assert not bool(saved.ok) and bool(torch.isnan(saved.qraw[1]).all())
    np.testing.assert_array_equal(Qr.numpy(), np.asarray(Qj))
    np.testing.assert_array_equal(hr.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(Qr.numpy(), c["Q0"].expand(B, -1).numpy())
    np.testing.assert_array_equal(hr.numpy(), 0.0)
    Qj, hj = jax_step(slice(0, 1))
    assert bool(kept.ok)
    np.testing.assert_allclose(Qk.numpy(), np.asarray(Qj), atol=1e-5)
    np.testing.assert_allclose(hk.numpy(), np.asarray(hj), atol=1e-5)
    assert not torch.equal(Qk, c["Q0"][None])


@pytest.mark.parametrize("kw,tol", [
    (FLAGSHIP, 2e-3), (dict(FLAGSHIP, fb_w_dtype="bfloat16"), 2e-2),
    (dict(FLAGSHIP, fixed_frontend_q=True), 2e-3),
    (dict(FLAGSHIP, fixed_frontend_q=True, fb_w_dtype="bfloat16"), 2e-2),
    (dict(FLAGSHIP, freeze_q=True), 2e-3),
])
def test_dual_frontend_matches_jax(kw, tol):
    cfg_j, params, model = _pair(kw, seed=4)
    wavL, wavR, _ = _wavs(4)
    with jax.default_matmul_precision("highest"):
        want = jfe.dual_frontend(params["bifb"], cfg_j, jnp.asarray(wavL),
                                 jnp.asarray(wavR), None, False)
    with torch.no_grad():
        got = model.bifb(_t(wavL), _t(wavR))
    names = ("YL", "YR", "QL", "QR", "phaseL", "phaseR")
    for name, g, w in zip(names, got, want):
        assert g.shape == (B, 19, 100), name
        w = np.asarray(w)
        if name.startswith("phase"):
            # compare angles on the circle; bands with |Z| near the 1e-3
            # floor carry no phase information on either side
            d = np.angle(np.exp(1j * (g.numpy() - w)))
            assert np.mean(np.abs(d) < 10 * tol) > 0.99, name
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=tol,
                                       atol=tol * max(1.0, np.abs(w).max()),
                                       err_msg=name)


def test_encoders_and_heads_match_jax():
    cfg_j, params, model = _pair(FLAGSHIP, seed=5)
    rng = np.random.default_rng(5)
    xL, xR = (rng.standard_normal((B, 19, 100)).astype(np.float32)
              for _ in range(2))
    feat = rng.standard_normal((B, 300)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        zi_j = jbe.ild_encoder(params["encoder_ild"], jnp.asarray(xL),
                               jnp.asarray(xR))
        zp_j = jbe.ipd_encoder(params["encoder_ipd"], jnp.asarray(xL),
                               jnp.asarray(xR))
        body_j = jbe.body_apply(params["body"], jnp.asarray(feat), None, False)
        heads_j = jbe.subheads_apply(params["subheads"], body_j, None, False)
    with torch.no_grad():
        zi_t = model.encoder_ild(tbe.ild_features(_t(xL), _t(xR)))
        zp_t = model.encoder_ipd(tbe.ipd_features(_t(xL), _t(xR)))
        body_t = model.body(_t(feat))
        heads_t = model.subheads(body_t)
    for g, w in ((zi_t, zi_j), (zp_t, zp_j), (body_t, body_j),
                 *zip(heads_t, heads_j)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


# ---------------- active_forward ----------------

@pytest.mark.parametrize("kw,tol", [
    (FLAGSHIP, 2e-3), (ABSOLUTE, 2e-3),
    (dict(FLAGSHIP, fb_w_dtype="bfloat16"), 2e-2),
    (dict(ABSOLUTE, fb_w_dtype="bfloat16"), 2e-2),
    (dict(FLAGSHIP, fixed_frontend_q=True), 2e-3),
])
def test_active_forward_matches_jax(kw, tol):
    cfg_j, params, model = _pair(kw, seed=6)
    wavL, wavR, x3 = _wavs(6)
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
    if not kw.get("fixed_frontend_q", False):
        q = got[3]["Q"].numpy()
        assert np.abs(q[:, 1:] - q[:, :1]).max() > 1e-4  # Q really adapts


def test_training_forward_is_refused():
    """Without a generator the training forward is refused (JAX refuses
    train=True without rng); with one it runs."""
    model = ActiveBiEAR(BiEARConfig(**FLAGSHIP)).init_weights_(0).train()
    w = torch.zeros(1, 16000)
    with pytest.raises(ValueError, match="requires a torch.Generator"):
        model(w, w)
    sound, aoa, dist, aux = model(w, w, gen=torch.Generator().manual_seed(0))
    assert sound.shape == (1, 8) and dist.shape == (1, 8, 5)
    assert bool(torch.isfinite(sound).all()) and sound.requires_grad


# ---------------- sanitisation and the serving slice ----------------

def test_sanitize_matches_jax():
    rng = np.random.default_rng(7)
    loud = (rng.standard_normal((3, 500)) * 8000).astype(np.float32)
    quiet = rng.uniform(-1.5, 1.5, (3, 500)).astype(np.float32)
    # one loud row rescales the WHOLE batch (one max over both ears)
    mixed = quiet.copy()
    mixed[1] *= 3000
    for wl, wr in ((loud, quiet), (quiet, quiet), (mixed, quiet)):
        got = tlo.sanitize_wav(_t(wl), _t(wr))
        want = jlo.sanitize_wav(jnp.asarray(wl), jnp.asarray(wr))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    x3 = rng.standard_normal((4, 100)).astype(np.float32) * 3
    x3[0, 3] = np.nan
    x3[2, 5] = np.inf
    x3[3] *= 0.1
    np.testing.assert_array_equal(tlo.sanitize_x3(_t(x3)).numpy(),
                                  np.asarray(jlo.sanitize_x3(jnp.asarray(x3))))


@pytest.mark.parametrize("kw,tol", [
    (dict(FLAGSHIP, fb_w_dtype="bfloat16"), 2e-2), (FLAGSHIP, 2e-3),
])
def test_predict_matches_jax_infer_composition(kw, tol):
    """The whole slice: the port's predict against tools/infer.py's
    composition (sanitize -> CC feature -> sanitize -> forward -> heads)."""
    cfg_j, params, model = _pair(kw, seed=8)
    wavL, wavR, _ = _wavs(8)
    wavL = wavL * 20000.0            # int16-range input takes the rescale

    @jax.jit
    def jax_predict(p, wavL, wavR):
        wavL, wavR = jlo.sanitize_wav(wavL, wavR)
        x3 = jlo.sanitize_x3(jax_cc_feature(wavL, wavR, cfg_j.fs,
                                            num_lags=cfg_j.n_bands))
        sound, aoa, dist, _ = active_forward(p, cfg_j, wavL, wavR, x3,
                                             train=False)
        return (jax.nn.sigmoid(sound), aoa, jax.nn.softmax(dist, axis=-1))

    want = jax_predict(params, jnp.asarray(wavL), jnp.asarray(wavR))
    got = tinfer.predict(model, wavL, wavR)
    for name, g, w in zip(("present", "aoa", "dist"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=1e-3, err_msg=name)
    assert got[0].shape == (B, 8) and got[2].shape == (B, 8, 5)
    np.testing.assert_allclose(got[2].sum(-1).numpy(), 1.0, atol=1e-6)


def test_config_from_settings_matches_jax():
    settings = {"USE_CC": True, "Controller_Mode": "dual", "ALPHA": 0.2,
                "DELTAQ_BASE": 1.0, "DELTAQ_LOW_FACTOR": 0.3,
                "DELTAQ_HIGH_FACTOR": 5.0, "DELTAQ_MODE": "relative",
                "GEOMETRY": {"FB_W_DTYPE": "bfloat16", "N_BANDS": 64}}
    for s in (settings, {}):
        got = tinfer.config_from_settings(s)
        want, _, _ = jax_config_from_settings(s)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.use_dft_matmul == want.use_dft_matmul
        assert got.fmax_eff == want.fmax_eff
    with pytest.raises(ValueError, match="FB_W_DTYPE"):
        tinfer.config_from_settings({"GEOMETRY": {"FB_W_DTYPE": "bf16"}})
    with pytest.raises(ValueError, match="fb_w_dtype"):
        BiEARConfig(fb_w_dtype="bf16")


def test_cli_serves_a_reference_format_checkpoint(tmp_path, capsys):
    """JAX params -> to_torch_state_dict -> .pth + meta/settings.json ->
    the port's CLI on the CPU, against predict on the same weights."""
    import json
    from scipy.io import wavfile

    cfg_j, params, model = _pair(FLAGSHIP, seed=9)
    run = tmp_path / "run"
    (run / "meta").mkdir(parents=True)
    (run / "meta" / "settings.json").write_text(json.dumps({
        "Active": True, "USE_CC": True, "Controller_Mode": "dual",
        "DELTAQ_BASE": 1.0, "DELTAQ_LOW_FACTOR": 0.3,
        "DELTAQ_HIGH_FACTOR": 5.0, "DELTAQ_MODE": "relative"}))
    sd = {k: torch.tensor(v) for k, v in
          to_torch_state_dict(params, cfg_j).items()}
    sd["bifb.fb_L.fc"] = torch.zeros(100)      # a reference-model buffer
    torch.save(sd, run / "best.pth")
    wavL, wavR, _ = _wavs(9)
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
    assert [r["file"] for r in recs] == paths
    pairs = [tinfer.read_stereo_wav(p, 16000) for p in paths]
    probs, _, _ = tinfer.predict(model, np.stack([a for a, _ in pairs]),
                                 np.stack([b for _, b in pairs]))
    for r, pr in zip(recs, probs.numpy()):
        np.testing.assert_allclose([s["present"] for s in r["sectors"]],
                                   pr, atol=1e-4)
