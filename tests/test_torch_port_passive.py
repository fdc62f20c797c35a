"""The port's passive family held against the JAX package (CPU).

The same numpy inputs, made from a seed, go through each JAX function and
its port:

  * ``ops.features.passive_features`` at 16 kHz and 19 frames (the pad
    branch: 18 frames of hop 842, n_fft 1024) and at a geometry with t = T
    frames (the crop branch), on synthesised mixtures and white noise,
    wherever JAX's magnitude is above -60 dB: the phase difference wrapped
    to (-pi, pi] within 1e-3 rad, and the magnitude to the same 1e-3 of
    the complex band value, 20 log10(1 + 1e-3) = 8.7e-3 dB. The 1e-3 dB
    that tests/test_passive_synth.py allows between two JAX compilations
    of the same FFT does not bound two FFT implementations: a band value
    is a sum over up to 513 bins that can cancel deeply, and JAX's own f32
    features lie up to 7.8e-3 dB (pad) and 4.0e-3 dB (crop) from float64
    ones on these inputs, the port 6.9e-3 and 3.7e-3 dB from JAX's, while
    TF32 products miss by 5.7 dB and more (``python
    tests/test_torch_port_passive.py`` prints these readings). So the port
    must also be no farther from the float64 features than twice JAX's own
    distance. The padded frame is -80 exactly; H and the window equal
    JAX's numpy constants bit for bit;
  * ``PassiveBiEAR`` against ``passive_forward`` with train=False, on
    seeded JAX weights and on docs/protocol_r3/passive/best.pth loaded
    strictly (``import_passive`` on the JAX side): logits within 1e-4;
  * ``PassiveFeatureSynth``: its batches are ``passive_features`` of the
    inner synthesizer's waveforms, bit for bit;
  * three passive train steps against JAX ``make_train_step(model=
    "passive")`` with dropout 0 (loss 5e-5, parameters 3e-3, the limits of
    tests/test_torch_port_train.py), and the runner against JAX ``train``
    per epoch on passive ``.shard`` splits under the same limits, from
    JAX's initial state and resumed from its epoch-1 checkpoint; a
    synthesised passive run resumes bit-identically.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biear_tpu.models import BiEARConfig as JaxConfig
from biear_tpu.models.biear import init_passive, passive_forward
from biear_tpu.ops import features as jfe
from biear_tpu.train import loop as jloop
from biear_tpu.train import optim as jopt
from biear_tpu.utils import torch_import as ti

from biear_tpu_torch import config as tcfg
from biear_tpu_torch import train_biear
from biear_tpu_torch.data import synth as tsy
from biear_tpu_torch.data.h5io import PassiveH5Dataset
from biear_tpu_torch.data.passive_synth import PassiveFeatureSynth
from biear_tpu_torch.kernels import LAUNCHES
from biear_tpu_torch.models import BiEARConfig, PassiveBiEAR, build_passive
from biear_tpu_torch.models.weights import state_dict_from_jax
from biear_tpu_torch.ops import features as tfe
from biear_tpu_torch.train import loop as tloop
from biear_tpu_torch.train import optim as topt
from biear_tpu_torch.train import runner as trun

import _torch_runner_common as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "protocol_r3", "passive", "best.pth")
FEAT_TOL = 1e-3                                   # relative, and rad
MAG_DB_TOL = 20.0 * np.log10(1.0 + FEAT_TOL)      # 8.7e-3 dB
LOGIT_TOL = 1e-4
TINY = dict(n_bands=16, timesteps=5, latent_dim=16, ctrl_dropout=0.0,
            backend_dropout=0.0)
# (fs, samples, frames): 16 kHz, 1 s, 19 frames is the pad branch (18
# frames); 16384 samples in 16 frames of hop = n_fft = 1024 is t = T
GEOMETRIES = {"pad": (16000, 16000, 19), "crop": (16000, 16384, 16)}


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _waves(n, seed=0, B=6):
    """Synthesised mixtures (peak 1) and white noise at several levels."""
    rng = np.random.default_rng(seed)
    ir, az, dist = tsy.make_test_hrir_bank()
    synth = tsy.AnechoicSynthesizer(
        ir, az, dist, tsy.make_test_segments(4, seg_len=n), fs=n,
        device="cpu")
    mix = synth.sample_batch(torch.Generator().manual_seed(seed),
                             B // 2)[0].numpy()
    noise = rng.uniform(-1, 1, (B - B // 2, n)) * np.array(
        [1.0, 0.1, 0.3] * B)[:B - B // 2, None]
    return np.concatenate([mix, noise]).astype(np.float32)


def _jax_features(wav, fs, T, D=100):
    return [np.asarray(a) for a in jfe.passive_features(jnp.asarray(wav), fs,
                                                        D, T)]


def _f64_features(wav, fs, T, D=100):
    """The same features in float64 (numpy), on the unpadded frames."""
    n_fft, hop, t, w, H = tfe.passive_consts(fs, wav.shape[1], T, D)
    frames = np.stack([wav[:, k * hop:k * hop + n_fft] for k in range(t)], 1)
    Z = np.fft.rfft(frames.astype(np.float64) * w, axis=-1) @ H.T.astype(
        np.float64)
    return 20.0 * np.log10(np.maximum(np.abs(Z), 1e-12)), np.angle(Z)


def feature_distances(geometry, tf32=False):
    """The port's and JAX's features of the same waveforms, and the float64
    ones, compared where JAX's magnitude is above -60 dB: the largest dB
    and wrapped-phase distances of JAX from float64, the port from float64
    and the port from JAX (the last over every frame, the padded one
    included). tf32=True rounds the port's products' inputs to TF32's
    10-bit mantissa, the fault that the limits must catch."""
    fs, n, T = GEOMETRIES[geometry]
    wav = _waves(n, seed=3)
    if tf32:
        def rnd(x):
            b = x.contiguous().view(torch.int32)
            return ((b + 0x1000) & ~0x1FFF).view(torch.float32)
        n_fft, hop, t, w, Ht = tfe._device_consts(fs, n, T, 100,
                                                  torch.device("cpu"))
        S = torch.fft.rfft(_t(wav).unfold(-1, n_fft, hop)[:, :t] * w)
        re, im = rnd(S.real) @ rnd(Ht), rnd(S.imag) @ rnd(Ht)
        got = [20.0 * torch.log10(torch.clamp(torch.sqrt(re ** 2 + im ** 2),
                                              min=tfe.MAG_FLOOR)),
               torch.atan2(im, re)]
    else:
        got = tfe.passive_features(_t(wav), fs, 100, T)
    mag, ph = (a.numpy() for a in got)
    jmag, jph = _jax_features(wav, fs, T)
    emag, eph = _f64_features(wav, fs, T)
    t = emag.shape[1]
    strong = jmag > -60.0
    s = strong[:, :t]
    wrap = lambda a, b: np.abs(np.angle(np.exp(1j * (a.astype(np.float64)
                                                     - b))))
    dist = {"jax-f64": (np.abs(jmag[:, :t] - emag)[s].max(),
                        wrap(jph[:, :t], eph)[s].max()),
            "port-f64": (np.abs(mag[:, :t] - emag)[s].max(),
                         wrap(ph[:, :t], eph)[s].max()),
            "port-jax": (np.abs(mag - jmag)[strong].max(),
                         wrap(ph, jph)[strong].max())}
    return dist, strong.mean(), (mag, ph), t


# ---------------- features ----------------

@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_filterbank_and_window_are_jax_constants(geometry):
    fs, n, T = GEOMETRIES[geometry]
    got = tfe.passive_consts(fs, n, T, 100)
    want = jfe._passive_consts(fs, n, T, 100, 50.0, None)
    assert got[:3] == want[:3]
    for g, w in zip(got[3:], want[3:]):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        tfe.build_gammatone_filterbank(8000, 512, 24, 80.0, 3000.0),
        jfe.build_gammatone_filterbank(8000, 512, 24, 80.0, 3000.0))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_passive_features_match_jax(geometry):
    fs, n, T = GEOMETRIES[geometry]
    n_fft, hop, t, _, _ = tfe.passive_consts(fs, n, T, 100)
    assert (t < T) == (geometry == "pad")
    if geometry == "pad":
        assert (n_fft, hop, t) == (1024, 842, 18)
    dist, strong_share, (mag, ph), _ = feature_distances(geometry)
    assert mag.shape == ph.shape == (6, T, 100) and strong_share > 0.1
    assert dist["port-jax"][0] <= MAG_DB_TOL, dist
    assert dist["port-jax"][1] <= FEAT_TOL, dist
    assert dist["port-f64"][0] <= 2.0 * dist["jax-f64"][0], dist
    if geometry == "pad":
        assert (mag[:, t:] == -80.0).all()
        np.testing.assert_array_equal(ph[:, t:], ph[:, t - 1:t])


# ---------------- the model ----------------

def test_passive_model_matches_jax_seeded():
    cfg_j, cfg_t = JaxConfig(), BiEARConfig()
    params = init_passive(jax.random.PRNGKey(2), cfg_j)
    model = PassiveBiEAR(cfg_t)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray,
                                                           params), cfg_t),
                          strict=True)
    assert not any(k.startswith("bifb.") for k in model.state_dict())
    wav = _waves(16000, seed=5, B=4)
    mag, ph = tfe.passive_features(_t(wav), 16000)
    rng = np.random.default_rng(6)
    x3 = rng.uniform(-1, 1, (4, 100)).astype(np.float32)
    feats = (mag[:2].numpy(), mag[2:].numpy(), x3[:2], ph[:2].numpy(),
             ph[2:].numpy())
    with jax.default_matmul_precision("highest"):
        want = passive_forward(params, cfg_j, *map(jnp.asarray, feats))
    with torch.no_grad():
        got = model(*map(_t, feats))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=LOGIT_TOL)


def test_passive_model_on_the_reference_checkpoint_matches_jax():
    sd = torch.load(CKPT, map_location="cpu", weights_only=True)
    assert len(sd) == 188
    assert {k.split(".")[0] for k in sd} == {
        "encoder_ild", "encoder_ipd", "body", "subheads", "cc_proj"}
    with open(os.path.join(os.path.dirname(CKPT), "settings.json")) as f:
        settings = json.load(f)
    cfg_t = tcfg.config_from_settings(settings)
    model = PassiveBiEAR(cfg_t)
    model.load_state_dict(sd, strict=True)
    cfg_j = JaxConfig()
    params = ti.import_passive(ti.load_state_dict(CKPT), cfg_j)
    ir, az, dist = tsy.make_test_hrir_bank()
    synth = tsy.AnechoicSynthesizer(ir, az, dist, tsy.make_test_segments(4),
                                    device="cpu")
    batch = PassiveFeatureSynth(synth).sample_batch(
        torch.Generator().manual_seed(1), 6)
    with jax.default_matmul_precision("highest"):
        want = passive_forward(params, cfg_j, *(jnp.asarray(b.numpy())
                                                for b in batch[:5]))
    with torch.no_grad():
        got = model(*batch[:5])
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=LOGIT_TOL)
    assert float(np.abs(np.asarray(want[0])).max()) > 1.0


def test_build_passive_is_seeded():
    a = build_passive(BiEARConfig(**TINY), seed=3, device="cpu")
    b = build_passive(BiEARConfig(**TINY), seed=3, device="cpu")
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    a.train()
    with pytest.raises(ValueError, match="requires a torch.Generator"):
        a(*(torch.zeros(1, 5, 16),) * 2, torch.zeros(1, 16),
          *(torch.zeros(1, 5, 16),) * 2)


# ---------------- the synthesizer adapter ----------------

@pytest.fixture(scope="module")
def inner():
    ir, az, dist = tsy.make_test_hrir_bank()
    return tsy.AnechoicSynthesizer(ir, az, dist, tsy.make_test_segments(4),
                                   device="cpu")


def test_passive_synth_emits_the_features_of_the_inner_batch(inner):
    pas = PassiveFeatureSynth(inner)
    assert pas.row_elems == 4 * 19 * 100 + 100 + 56
    assert pas.bank is inner.bank and pas.device == inner.device
    LAUNCHES.clear()
    wavL, wavR, x3, y = inner.sample_batch(torch.Generator().manual_seed(7), 4)
    batch = pas.sample_batch(torch.Generator().manual_seed(7), 4)
    assert len(batch) == 6 and sum(LAUNCHES.values()) == 0
    x1, x4 = tfe.passive_features(wavL)
    x2, x5 = tfe.passive_features(wavR)
    for got, want in zip(batch, (x1, x2, x3, x4, x5, y)):
        assert torch.equal(got, want)
    assert batch[0].shape == (4, 19, 100)
    via_fn = pas.batch_fn(4)(torch.Generator().manual_seed(7))
    for a, b in zip(batch, via_fn):
        assert torch.equal(a, b)


def test_passive_h5_reader(tmp_path):
    h5py = pytest.importorskip("h5py")
    arrays = C.passive_dataset().arrays
    path = str(tmp_path / "p.h5")
    with h5py.File(path, "w") as f:
        for k, a in zip(PassiveH5Dataset.KEYS, arrays):
            f[k] = a
    for preload in (True, False):
        ds = PassiveH5Dataset(path, preload=preload)
        assert len(ds) == C.ROWS
        for g, w in zip(ds.rows([3, 0, 3]), arrays):
            np.testing.assert_array_equal(g, w[[3, 0, 3]])
        ds.close()


# ---------------- train steps ----------------

def test_three_passive_steps_match_jax():
    cfg_j, cfg_t = JaxConfig(**TINY), BiEARConfig(**TINY)
    params = init_passive(jax.random.PRNGKey(4), cfg_j)
    model = PassiveBiEAR(cfg_t)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray,
                                                           params), cfg_t),
                          strict=True)
    rng = np.random.default_rng(8)
    y = C.dataset(9).arrays[3]
    tb = (4, TINY["timesteps"], TINY["n_bands"])
    batches = [(rng.uniform(-80, 0, tb), rng.uniform(-80, 0, tb),
                rng.uniform(-1, 1, tb[::2]), rng.uniform(-np.pi, np.pi, tb),
                rng.uniform(-np.pi, np.pi, tb), y[4 * i:4 * i + 4])
               for i in range(3)]
    batches = [tuple(a.astype(np.float32) for a in b) for b in batches]
    hp = topt.TrainHyper()
    opt_j = jopt.make_optimizer(params, hp)
    state = opt_j.init(params)
    step_j = jloop.make_train_step(cfg_j, hp, opt_j, "passive")
    losses_j = []
    with jax.default_matmul_precision("highest"):
        for i, b in enumerate(batches):
            params, state, m = step_j(params, state,
                                      tuple(map(jnp.asarray, b)),
                                      jax.random.PRNGKey(i), jnp.float32(1.0))
            losses_j.append(float(m["loss"]))
    opt = topt.make_optimizer(model, hp)
    assert [g.label for g in opt.groups] == ["backend"]
    step = tloop.make_train_step(model, hp, opt)
    losses_t = []
    for b in batches:
        m = step(tuple(map(_t, b)), torch.Generator())
        assert float(m["skipped"]) == 0.0 and float(m["grad_fb_norm"]) == 0
        losses_t.append(float(m["loss"]))
    assert np.abs(np.array(losses_t) - losses_j).max() < C.LOSS_TOL
    C.assert_params(model, jax.tree.map(np.asarray, params))
    ev = tloop.make_eval_step(model, hp)(tuple(map(_t, batches[0])))
    ev_j = jloop.make_eval_step(cfg_j, hp, "passive")(
        params, tuple(map(jnp.asarray, batches[0])))
    assert abs(float(ev["loss"]) - float(ev_j["loss"])) < C.LOSS_TOL


# ---------------- the runner ----------------

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    with C.small_cpu():
        yield C.jax_run("passive", tmp_path_factory.mktemp("jax_runs"))


def test_adam_state_from_optax_reads_the_passive_shape(jax_run):
    C.check_adam_conversion("passive", jax_run)


def test_passive_runner_matches_jax_on_shard_splits(jax_run, tmp_path):
    """Both runners start from JAX's initial state and train 2 epochs on
    the same .shard splits."""
    run = jax_run
    rc = C.run_config(False, tmp_path, "passive", run["shard_root"])
    assert tcfg.is_passive(rc) and rc.data_format == "shard"
    params_np, opt_np = run["init"]
    with C.small_cpu():
        out = C.port_train(rc, C.port_run_from(tmp_path, params_np, opt_np,
                                               {"epoch": 0}, rc.model_cfg))
    assert isinstance(out["model"], PassiveBiEAR)
    C.assert_losses(out["history"], run["history"], (0, 1))
    p2, _, meta = C.restore_jax(run, os.path.join(
        run["run_dir"], "checkpoints", "last"))
    C.assert_params(out["model"], p2)
    assert out["global_step"] == meta["global_step"] == 6
    assert np.isfinite(out["test"]["loss"])


def test_port_resumes_a_jax_passive_checkpoint(jax_run, tmp_path):
    with C.small_cpu():
        C.check_port_resume("passive", jax_run, tmp_path)


def test_synthesised_passive_run_resumes_bit_identically(tmp_path):
    """conf/config_passive.yaml synthesised through make_synth (the
    PassiveFeatureSynth wrapper): two epochs straight equal one epoch and
    a resume, bit for bit, with dropout on."""
    runs = {}
    with C.small_cpu():
        for name, stages in (("straight", (2,)), ("resumed", (1, 2))):
            rc = tcfg.load_run_config(C.CONF_PASSIVE)
            rc.runs_root, rc.epochs, rc.batch_size = (str(tmp_path / name),
                                                      stages[0], 2)
            rc.synth_on_device = True
            rc.raw = dict(rc.raw, SYNTH_STEPS_PER_EPOCH=3,
                          SYNTH_CHUNK_STEPS=2, SYNTH_EVAL_SAMPLES=5)
            rc.model_cfg = BiEARConfig(n_bands=16, timesteps=5,
                                       latent_dim=16)
            synth = train_biear.make_synth(rc, "cpu")
            assert isinstance(synth, PassiveFeatureSynth)
            out = trun.train(rc, synth=synth, run_id="P", quiet=True,
                             device="cpu")
            for epochs in stages[1:]:
                rc.epochs = epochs
                out = trun.train(rc, synth=synth, quiet=True, device="cpu",
                                 resume_from=out["run_dir"])
            runs[name] = out
    a, b = runs["straight"], runs["resumed"]
    assert a["global_step"] == b["global_step"] == 6
    for k, v in a["model"].state_dict().items():
        assert torch.equal(v, b["model"].state_dict()[k]), k
    for split in ("train", "val"):
        strip = lambda h: [{k: v for k, v in e.items() if k != "sec"}
                           for e in h[split]]
        assert strip(a["history"]) == strip(b["history"])
        assert all(np.isfinite(e["loss"]) for e in a["history"][split])
    assert a["test"]["loss"] == b["test"]["loss"]


if __name__ == "__main__":
    # the readings behind MAG_DB_TOL: JAX_PLATFORMS=cpu PYTHONPATH=. python
    # tests/test_torch_port_passive.py
    for geometry in sorted(GEOMETRIES):
        for tf32 in (False, True):
            dist, share, _, _ = feature_distances(geometry, tf32)
            print(geometry, "tf32" if tf32 else "f32", f"strong {share:.3f}",
                  " ".join(f"{k} {d[0]:.3e} dB {d[1]:.3e} rad"
                           for k, d in dist.items()))
