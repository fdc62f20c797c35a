"""AuralNet in the PyTorch port, held against the JAX package (CPU).

JAX parameters are initialised from a seed and carried over with
``state_dict_from_jax`` (``strict=True``); the same numpy inputs go
through both sides. Limits: the fixed filterbank to 1e-5 relative on Y
and its log features to 1e-4; the eval forward's logits to 1e-4, at full
width (conf/config_auralnet_deepear.yaml: 100 bands, 19 frames, width
128, 4 heads, 2 layers per block) and at a small width, with and without
the CC feature; three train steps with dropout 0 at the trajectory
test's limits (loss 5e-5, parameters 3e-3, tests/test_torch_port_train.py);
the runner per epoch at the same limits, from JAX's initial state and
from its epoch-1 checkpoint (tests/_torch_runner_common.py); ``evaluate``
of a port-written checkpoint as JAX ``evaluate`` reads it (predictions
equal except within the forward's tolerance of a boundary, MAE 1e-4).
The archived AuralNet checkpoints hold no attention weights: the port
refuses them by name, as JAX's ``import_auralnet`` does.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biear_tpu.config import config_from_settings as jax_config
from biear_tpu.data.native_loader import ShardDataset as JaxShardDataset
from biear_tpu.models import BiEARConfig as JaxConfig
from biear_tpu.models import frontend as jfe
from biear_tpu.models.auralnet import auralnet_forward, init_auralnet
from biear_tpu.ops.xcorr import cross_correlation_feature as jax_cc_feature
from biear_tpu.train import evaluate as jev
from biear_tpu.train import loop as jloop
from biear_tpu.train import losses as jlo
from biear_tpu.train import optim as jopt
from biear_tpu.utils import torch_import as ti

from biear_tpu_torch.data.shard import ShardDataset, write_shard
from biear_tpu_torch.models import AuralNet, BiEARConfig, build_auralnet
from biear_tpu_torch.models.auralnet import sinusoidal_pe
from biear_tpu_torch.models.frontend import auralnet_fb, device_constants
from biear_tpu_torch.models.weights import state_dict_from_jax
from biear_tpu_torch.serve import infer as tinfer
from biear_tpu_torch.serve import streaming as tstream
from biear_tpu_torch.train import evaluate as tev
from biear_tpu_torch.train import loop as tloop
from biear_tpu_torch.train import optim as topt

import _torch_runner_common as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHIVED = os.path.join(REPO, "docs", "protocol_r3", "auralnet")
MISSING = "attn_L.encoder.layers.0.self_attn.in_proj_weight"
# conf/config_auralnet_deepear.yaml's geometry: fixed Q, absolute deltaQ
FULL = dict(fixed_frontend_q=True, deltaQ_mode="absolute", deltaQ_base=2.0,
            deltaQ_low_factor=0.5, deltaQ_high_factor=1.0)
SMALL = dict(FULL, fs=16000, timesteps=5, n_bands=24, d_model=32,
             attn_heads=4, attn_layers=2)
FB_REL, FEAT_ATOL, LOGIT_ATOL = 1e-5, 1e-4, 1e-4
FWD_TOL = 2e-2         # the bf16 policy's forward tolerance (evaluate test)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(kw, seed=0):
    """(jax cfg, jax params, port model) with the same weights."""
    cfg_j, cfg_t = JaxConfig(**kw), BiEARConfig(**kw)
    params = init_auralnet(jax.random.PRNGKey(seed), cfg_j)
    model = AuralNet(cfg_t)
    model.load_state_dict(state_dict_from_jax(_np_tree(params), cfg_t),
                          strict=True)
    return cfg_j, params, model


def _inputs(seed, B, n_bands, fs=16000):
    rng = np.random.default_rng(seed)
    wav = rng.uniform(-1, 1, (2, B, fs)).astype(np.float32)
    return wav[0], wav[1], rng.uniform(-1, 1, (B, n_bands)).astype(np.float32)


def _fake_targets(rng, B):
    y = np.zeros((B, 8, 7), np.float32)
    y[:, :, 2] = 1.0
    for b in range(B):
        for s in rng.choice(8, size=rng.integers(1, 4), replace=False):
            y[b, s, :2] = (1.0, rng.uniform())
            y[b, s, 2:] = 0.0
            y[b, s, 2 + rng.integers(1, 5)] = 1.0
    return y.reshape(B, 56)


# ---------------- the fixed filterbank ----------------

@pytest.mark.parametrize("dft_mode", ["fft", "matmul"])
def test_auralnet_fb_and_log_features_match_jax(dft_mode):
    kw = dict(SMALL, n_bands=32, timesteps=6, dft_mode=dft_mode)
    cfg_j, cfg_t = JaxConfig(**kw), BiEARConfig(**kw)
    wl, _, _ = _inputs(1, 3, 32)
    with jax.default_matmul_precision("highest"):
        Yj = np.asarray(jfe.auralnet_fb(cfg_j, jnp.asarray(wl)))
    Yt = auralnet_fb(cfg_t, torch.as_tensor(wl),
                     device_constants(cfg_t, "cpu")).numpy()
    assert Yt.shape == Yj.shape == (3, 6, 32)
    assert np.abs(Yt - Yj).max() <= FB_REL * np.abs(Yj).max()
    np.testing.assert_allclose(Yt, Yj, rtol=FB_REL, atol=0)
    feat = lambda Y: np.clip(np.log(Y + 1e-8), -12.0, 12.0)
    np.testing.assert_allclose(feat(Yt), feat(Yj), rtol=0, atol=FEAT_ATOL)


def test_positional_encoding_is_jax_s():
    from biear_tpu.models.auralnet import _sinusoidal_pe
    for T, d in ((19, 128), (5, 32), (3, 8)):
        np.testing.assert_array_equal(sinusoidal_pe(T, d),
                                      _sinusoidal_pe(T, d))


# ---------------- the eval forward ----------------

@pytest.mark.parametrize("kw,use_x3", [
    (FULL, True), (SMALL, True), (dict(SMALL, use_cc=False), True),
    (SMALL, False), (dict(SMALL, fb_w_dtype="bfloat16"), True)],
    ids=["full-width", "small", "small-no-cc", "small-x3-none",
         "small-bf16-policy"])
def test_forward_matches_jax(kw, use_x3):
    cfg_j, params, model = _pair(kw, seed=2)
    wl, wr, x3 = _inputs(3, 2, cfg_j.n_bands)
    x3j = jnp.asarray(x3) if use_x3 else None
    with jax.default_matmul_precision("highest"):
        want = auralnet_forward(params, cfg_j, jnp.asarray(wl),
                                jnp.asarray(wr), x3j)
    with torch.no_grad():
        got = model(torch.as_tensor(wl), torch.as_tensor(wr),
                    torch.as_tensor(x3) if use_x3 else None)
    assert got[3] == {"Q": None} and want[3] == {"Q": None}
    for g, w in zip(got[:3], want[:3]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=LOGIT_ATOL)


def test_full_width_model_has_the_reference_layout():
    """246 tensors in the reference layout (106 JAX leaves, 2.08 M
    parameters), and every name is one import_auralnet reads."""
    cfg = BiEARConfig(**FULL)
    params = init_auralnet(jax.random.PRNGKey(0), JaxConfig(**FULL))
    sd = AuralNet(cfg).state_dict()
    assert len(sd) == 246 and len(jax.tree.leaves(params)) == 106
    assert sum(t.numel() for t in sd.values()) == sum(
        a.size for a in jax.tree.leaves(params)) == 2_084_256
    assert set(sd) == set(state_dict_from_jax(_np_tree(params), cfg))
    assert MISSING in sd


def test_names_round_trip_through_jax_import_auralnet():
    """The port's state dict (its own seeded init) read by JAX's importer:
    JAX's forward equals the port's."""
    cfg_t = BiEARConfig(**SMALL)
    model = build_auralnet(cfg_t, seed=5, device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    cfg_j = JaxConfig(**SMALL)
    params = ti.import_auralnet(sd, cfg_j)
    back = state_dict_from_jax(_np_tree(params), cfg_t)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    wl, wr, x3 = _inputs(4, 2, cfg_t.n_bands)
    with jax.default_matmul_precision("highest"):
        want = auralnet_forward(params, cfg_j, wl, wr, x3)
    with torch.no_grad():
        got = model(*(torch.as_tensor(a) for a in (wl, wr, x3)))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=LOGIT_ATOL)


def test_seeded_init_follows_jax_s_scheme():
    """Packed in-projection xavier-uniform (fan 3d + d) with zero bias,
    torch's Linear bounds, LayerNorm ones / zeros, as init_auralnet."""
    model = build_auralnet(BiEARConfig(**SMALL), seed=0, device="cpu")
    a = model.attn_L.encoder.layers[0]
    d = SMALL["d_model"]
    w_in = float(a.self_attn.in_proj_weight.detach().abs().max())
    assert 0.9 * (6 / (4 * d)) ** .5 < w_in <= (6 / (4 * d)) ** .5
    assert float(a.self_attn.in_proj_bias.detach().abs().max()) == 0.0
    assert float(a.linear2.weight.detach().abs().max()) <= 1 / (4 * d) ** .5
    assert torch.equal(a.norm1.weight, torch.ones(d))
    again = build_auralnet(BiEARConfig(**SMALL), seed=0, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k


def test_training_mode_draws_dropout_from_the_generator():
    cfg = BiEARConfig(**SMALL)
    model = build_auralnet(cfg, seed=1, device="cpu").train()
    x = [torch.as_tensor(a) for a in _inputs(5, 2, cfg.n_bands)]
    with pytest.raises(ValueError, match="Generator"):
        model(*x)
    with torch.no_grad():
        a = model(*x, gen=torch.Generator().manual_seed(3))[0]
        b = model(*x, gen=torch.Generator().manual_seed(3))[0]
        c = model(*x, gen=torch.Generator().manual_seed(4))[0]
        e = model.eval()(*x)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, e)


def test_predict_matches_jax_serving_composition():
    """serve.infer.predict on AuralNet: sanitize, CC, sanitize, forward,
    sigmoid / softmax, as tools/infer.py composes it for AuralNet."""
    cfg_j, params, model = _pair(SMALL, seed=6)
    wl, wr, _ = _inputs(7, 3, 24)
    with jax.default_matmul_precision("highest"):
        jl, jr = jlo.sanitize_wav(jnp.asarray(wl), jnp.asarray(wr))
        x3 = jlo.sanitize_x3(jax_cc_feature(jl, jr, cfg_j.fs,
                                            num_lags=cfg_j.n_bands))
        s, a, d, _ = auralnet_forward(params, cfg_j, jl, jr, x3)
        want = (jax.nn.sigmoid(s), a, jax.nn.softmax(d, axis=-1))
    got = tinfer.predict(model, wl, wr)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=LOGIT_ATOL)


def test_stream_init_refuses_auralnet():
    model = build_auralnet(BiEARConfig(**SMALL), device="cpu")
    with pytest.raises(NotImplementedError, match="not streamable"):
        tstream.stream_init(model, 2)


def test_archived_checkpoint_lacks_the_attention_weights():
    """docs/protocol_r3/auralnet{,-s1}/best.pth: cc_proj, body and
    subheads only (168 tensors). JAX's import fails on the first attention
    key; the port's load_model and serving CLI name it."""
    with open(os.path.join(ARCHIVED, "settings.json")) as f:
        settings = json.load(f)
    for d in ("auralnet", "auralnet-s1"):
        sd = ti.load_state_dict(os.path.join(REPO, "docs", "protocol_r3", d,
                                             "best.pth"))
        assert len(sd) == 168 and not any(k.startswith("attn_") for k in sd)
        with pytest.raises(KeyError, match=MISSING):
            ti.import_auralnet(sd, jax_config(settings)[0])
    cfg = tev.config_from_settings(settings)
    with pytest.raises(RuntimeError, match=MISSING):
        tinfer.load_model(os.path.join(ARCHIVED, "best.pth"), cfg, "cpu",
                          kind="auralnet")


# ---------------- training ----------------

def test_three_step_trajectory_matches_jax():
    kw = dict(SMALL, attn_dropout=0.0, backend_dropout=0.0)
    cfg_j, params, model = _pair(kw, seed=0)
    rng = np.random.default_rng(10)
    batches = [(*_inputs(20 + i, 4, cfg_j.n_bands), _fake_targets(rng, 4))
               for i in range(3)]
    hp = topt.TrainHyper()
    opt_j = jopt.make_optimizer(params, hp)
    state = opt_j.init(params)
    step_j = jloop.make_train_step(cfg_j, hp, opt_j, "auralnet")
    p = jax.tree.map(jnp.copy, params)
    losses_j = []
    with jax.default_matmul_precision("highest"):
        for i, b in enumerate(batches):
            p, state, m = step_j(p, state, tuple(jnp.asarray(a) for a in b),
                                 jax.random.PRNGKey(i), jnp.float32(1.0))
            losses_j.append(float(m["loss"]))
            assert float(m["skipped"]) == 0.0
    opt = topt.make_optimizer(model, hp)
    assert [g.label for g in opt.groups] == ["backend"]
    assert opt.groups[0].clip == hp.grad_clip_norm
    step = tloop.make_train_step(model, hp, opt)
    losses_t = []
    for b in batches:
        m = step(tuple(torch.as_tensor(a) for a in b), torch.Generator())
        assert float(m["skipped"]) == 0.0
        assert float(m["grad_fb_norm"]) == 0.0
        losses_t.append(float(m["loss"]))
    assert np.abs(np.array(losses_t) - np.array(losses_j)).max() < 5e-5, (
        losses_t, losses_j)
    want = state_dict_from_jax(_np_tree(p), model.cfg)
    got = model.state_dict()
    diffs = {k: float((got[k] - want[k]).abs().max()) for k in want}
    assert max(diffs.values()) < 3e-3, sorted(diffs.items(),
                                              key=lambda kv: -kv[1])[:5]
    assert int(opt.groups[0].count) == 3
    moved = got[MISSING] - state_dict_from_jax(_np_tree(params),
                                               model.cfg)[MISSING]
    assert float(moved.abs().max()) > 0


def test_eval_step_matches_jax():
    cfg_j, params, model = _pair(SMALL, seed=3)
    rng = np.random.default_rng(3)
    b = (*_inputs(3, 4, cfg_j.n_bands), _fake_targets(rng, 4))
    hp = topt.TrainHyper()
    with jax.default_matmul_precision("highest"):
        mj = jloop.make_eval_step(cfg_j, hp, "auralnet")(
            params, tuple(jnp.asarray(a) for a in b))
    mt = tloop.make_eval_step(model, hp)(tuple(torch.as_tensor(a)
                                               for a in b))
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), atol=2e-5,
                                   err_msg=k)


# ---------------- the runner ----------------

@pytest.fixture(scope="module")
def small_cpu():
    with C.small_cpu():
        yield


@pytest.fixture(scope="module")
def jax_run(small_cpu, tmp_path_factory):
    return C.jax_run("auralnet", tmp_path_factory.mktemp("jax_auralnet"))


def test_adam_state_from_optax_reads_the_auralnet_chain(jax_run):
    C.check_adam_conversion("auralnet", jax_run)


def test_runner_matches_jax_from_jax_initial_state(jax_run, tmp_path):
    """Both runners start from JAX's initial AuralNet state and train the
    same 2 epochs on the same batches; nothing is written to q_vis/."""
    run = jax_run
    rc = C.run_config(False, tmp_path, "auralnet")
    assert rc.model_kind == "auralnet" and rc.fixed_frontend_q
    params_np, opt_np = run["init"]
    out = C.port_train(rc, C.port_run_from(tmp_path, params_np, opt_np,
                                           {"epoch": 0}, rc.model_cfg))
    assert isinstance(out["model"], AuralNet)
    C.assert_losses(out["history"], run["history"], (0, 1))
    p2, _, meta = C.restore_jax(run, os.path.join(
        run["run_dir"], "checkpoints", "last"))
    C.assert_params(out["model"], p2)
    assert out["global_step"] == meta["global_step"] == 6
    assert os.listdir(os.path.join(out["run_dir"], "q_vis")) == []
    with open(os.path.join(out["run_dir"], "meta", "settings.json")) as f:
        assert json.load(f)["MODEL_KIND"] == "auralnet"


def test_port_resumes_a_jax_auralnet_checkpoint(jax_run, tmp_path):
    C.check_port_resume("auralnet", jax_run, tmp_path)


# ---------------- evaluate ----------------

def test_evaluate_port_checkpoint_matches_jax(tmp_path):
    """A seeded AuralNet at full width under the archived run's settings
    (bf16 policy), written by the port's runner checkpoint writer, is
    evaluated by both packages on one 48-row shard: predictions equal
    except rows within the forward's 2e-2 of a boundary (at most one),
    MAE to 1e-4."""
    from biear_tpu_torch.train.state import save_checkpoint
    with open(os.path.join(ARCHIVED, "settings.json")) as f:
        settings = json.load(f)
    rows = 48
    rng = np.random.default_rng(8)
    wav = rng.uniform(-1, 1, (2, rows, 16000)).astype(np.float32)
    x3 = rng.uniform(-1, 1, (rows, 100)).astype(np.float32)
    shard = str(tmp_path / "test.shard")
    write_shard(shard, [wav[0], wav[1], x3, _fake_targets(rng, rows)],
                ["i16", "i16", "f32", "f32"])
    cfg = tev.config_from_settings(settings)
    model = build_auralnet(cfg, seed=9, device="cpu")
    save_checkpoint(str(tmp_path / "best"), model)
    pth = str(tmp_path / "best" / "params.pth")
    got_m = tev.evaluate(str(tmp_path / "best"), settings=settings,
                         test_shard=shard, batch_size=20, device="cpu",
                         out_path=str(tmp_path / "t.json"))
    shapes = [(16000,), (16000,), (100,), (56,)]
    got = tev.collect_predictions(model, ShardDataset(shard, shapes), 20)
    cfg_j = jax_config(settings)[0]
    jds = JaxShardDataset(shard, shapes=shapes)
    params = ti.import_auralnet(ti.load_state_dict(pth), cfg_j)
    want = jev._collect_predictions(params, cfg_j, jds, 16, True, "auralnet")
    want_m = jev.evaluate(pth, dataset=jds, batch_size=16, settings=settings,
                          out_path=str(tmp_path / "j.json"), quiet=True)
    np.testing.assert_array_equal(got[3], want[3])
    spread = np.maximum(np.abs(got[0] - want[0]).max(1),
                        np.abs(got[2] - want[2]).max((1, 2)))
    assert spread.max() <= FWD_TOL
    top2 = np.sort(want[2], axis=-1)[..., -2:]
    flip = np.concatenate([(got[0] > 0) != (want[0] > 0),
                           got[2].argmax(-1) != want[2].argmax(-1)], 1)
    near = np.concatenate([np.abs(want[0]) <= FWD_TOL,
                           top2[..., 1] - top2[..., 0] <= 2 * FWD_TOL], 1)
    assert not (flip & ~near).any() and flip.any(1).sum() <= 1
    assert set(got_m) == set(want_m) == {"overall", "1spk", "2spk", "3spk"}
    for split in want_m:
        assert abs(got_m[split]["aoa_mae"]
                   - want_m[split]["aoa_mae"]) <= 1e-4, split


def test_infer_cli_serves_an_auralnet_run(tmp_path, capsys):
    """python -m biear_tpu_torch.serve.infer on a runner-layout AuralNet
    checkpoint (settings in meta/settings.json) with --device cpu."""
    from scipy.io import wavfile
    with open(os.path.join(ARCHIVED, "settings.json")) as f:
        settings = json.load(f)
    settings["GEOMETRY"] = dict(settings["GEOMETRY"], N_BANDS=24, D_MODEL=32)
    (tmp_path / "meta").mkdir()
    (tmp_path / "meta" / "settings.json").write_text(json.dumps(settings))
    cfg = tev.config_from_settings(settings)
    model = build_auralnet(cfg, seed=2, device="cpu")
    torch.save(model.state_dict(), tmp_path / "best.pth")
    wl, wr, _ = _inputs(11, 1, 24)
    path = str(tmp_path / "a.wav")
    wavfile.write(path, 16000, np.stack([wl[0], wr[0]], 1))
    tinfer.main(["--checkpoint", str(tmp_path / "best.pth"), path,
                 "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip())
    left, right = tinfer.read_stereo_wav(path, 16000)
    want = tinfer.predict(model, left[None], right[None])
    got = [s["present"] for s in rec["sectors"]]
    np.testing.assert_allclose(got, want[0][0].numpy(), atol=1e-4)
