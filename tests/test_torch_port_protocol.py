"""The protocol tools of the port and the runner's Q plots, held against the
JAX package (CPU).

  * ``data/speech.py::make_speech_pool`` is bit-equal to JAX's for the
    same seed, at the 1 s segment and at the protocol's fs + 7 * 128;
  * ``run_full_protocol.full_metrics`` equals the JAX tool's on the same
    prediction arrays;
  * ``run_full_protocol``, ``protocol_eval`` and ``eval_by_snr`` run end to
    end on the CPU at a tiny scale (AuralNet and the fixed-Q flagship at
    16 bands, 3 frames, batch 4, one epoch, the speech corpus, noise at
    5-25 dB) and write their JSON; ``protocol_eval`` on the protocol run's
    directory reproduces its test1 / test2 files byte for byte;
  * ``utils/qvis.py::visualize_Q_LR`` writes JAX's ``.npz`` (Q to 1e-4)
    for the same weights and batch, and the runner writes ``q_vis/`` for
    an active run and nothing for a passive one (AuralNet:
    tests/test_torch_port_auralnet.py).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biear_tpu.data import speech as jspeech
from biear_tpu.models import BiEARConfig as JaxConfig
from biear_tpu.models.biear import init_active
from biear_tpu.utils import qvis as jqvis

from biear_tpu_torch import config as tcfg
from biear_tpu_torch import eval_by_snr, protocol_eval, run_full_protocol
from biear_tpu_torch import train_biear
from biear_tpu_torch.data import speech as tspeech
from biear_tpu_torch.data import synth as tsynth
from biear_tpu_torch.models import ActiveBiEAR, BiEARConfig
from biear_tpu_torch.models.weights import state_dict_from_jax
from biear_tpu_torch.train import runner as trun
from biear_tpu_torch.utils.qvis import visualize_Q_LR

import _torch_runner_common as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)                 # tools/ is imported as a package
from tools import run_full_protocol as jproto  # noqa: E402

SPLITS = {"overall", "1spk", "2spk", "3spk"}
# the protocol's tiny scale: a few batches of 4, one epoch
TINY_ARGS = ["--corpus", "speech", "--noise-snr", "5,25", "--train-size",
             "8", "--eval-size", "12", "--pool-size", "6", "--epochs", "1",
             "--device", "cpu", "--quiet"]
TINY_YAML = {"BATCH_SIZE": 4, "N_BANDS": 16, "TIMESTEPS": 3, "D_MODEL": 32,
             "LATENT_DIM": 16}


@pytest.mark.parametrize("seed", [0, 9999])
@pytest.mark.parametrize("seg_len", [16000, 16896])
def test_make_speech_pool_is_bit_equal_to_jax(seed, seg_len):
    got = tspeech.make_speech_pool(4, seg_len=seg_len, seed=seed)
    want = jspeech.make_speech_pool(4, seg_len=seg_len, seed=seed)
    assert got.dtype == np.float32 and got.shape == (4, seg_len)
    np.testing.assert_array_equal(got, want)
    assert float(np.abs(got).max()) == 1.0


def test_full_metrics_equals_jax():
    rng = np.random.default_rng(0)
    n = 240
    y = np.zeros((n, 8, 7), np.float32)
    y[:, :, 2] = 1.0
    for b in range(n):
        for s in rng.choice(8, size=1 + b % 3, replace=False):
            y[b, s, :2] = (1.0, rng.uniform())
            y[b, s, 2:] = 0.0
            y[b, s, 2 + rng.integers(1, 5)] = 1.0
    s = (rng.standard_normal((n, 8)) * 3).astype(np.float32)
    a = rng.uniform(0, 1, (n, 8)).astype(np.float32)
    d = rng.standard_normal((n, 8, 5)).astype(np.float32)
    got = run_full_protocol.full_metrics(s, a, d, y.reshape(n, 56))
    want = jproto.full_metrics(s, a, d, y.reshape(n, 56))
    assert got == want and set(got) == SPLITS


def test_build_synthesizer_takes_noise_and_the_mix_dtype():
    segs = tsynth.make_test_segments(4)
    sy = tsynth.build_synthesizer("anechoic", None, segs, 16000, num_lags=16,
                                  noise_snr_db=(5, 25), mix_dtype="bfloat16",
                                  device="cpu")
    assert sy.noise_snr_db == (5.0, 25.0) and sy.mix_dtype == "bfloat16"
    rs = tsynth.build_synthesizer("spirit", None, segs, 16000, num_lags=16,
                                  noise_snr_db=(10, 10), device="cpu")
    assert rs.noise_snr_db == (10.0, 10.0)
    plain = tsynth.build_synthesizer("anechoic", None, segs, 16000,
                                     num_lags=16, device="cpu")
    assert plain.noise_snr_db is None and plain.mix_dtype == "float32"


# ---------------- Q plots ----------------

def test_visualize_q_writes_jax_s_npz(tmp_path):
    kw = dict(fs=1600, timesteps=4, n_fft=256, n_bands=24, fmin=50.0,
              fmax=700.0, latent_dim=24, deltaQ_mode="relative")
    cfg_j, cfg_t = JaxConfig(**kw), BiEARConfig(**kw)
    params = init_active(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(1)
    l3 = params["bifb"]["fb"]["q_out"]["l3"]
    for k in ("w", "b"):          # non-zero output layers: Q adapts
        l3[k] = jnp.asarray(rng.uniform(-0.05, 0.05, l3[k].shape),
                            jnp.float32)
    model = ActiveBiEAR(cfg_t)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), cfg_t), strict=True)
    batches = [tuple(rng.uniform(-1, 1, shape).astype(np.float32)
                     for shape in ((3, 1600), (3, 1600), (3, 24)))
               for _ in range(3)]
    with jax.default_matmul_precision("highest"):
        jqvis.visualize_Q_LR(params, cfg_j, batches, str(tmp_path / "j"),
                             max_batches=2, sample_per_batch=2)
    visualize_Q_LR(model, batches, str(tmp_path / "t"), max_batches=2,
                   sample_per_batch=2)
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    assert "q_batch001.npz" in names and "q_batch002.npz" not in names
    for bi in range(2):
        got = np.load(tmp_path / "t" / f"q_batch{bi:03d}.npz")
        want = np.load(tmp_path / "j" / f"q_batch{bi:03d}.npz")
        assert set(got.files) == set(want.files) == {"QL", "QR", "fc", "Q0"}
        assert got["QL"].shape == (2, 4, 24)
        for k in ("QL", "QR"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4)
        assert float(np.abs(got["QL"] - got["Q0"]).max()) > 1e-3
        for k in ("fc", "Q0"):
            np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def one_thread():
    """One torch thread and no TensorBoard (its import can pull in
    TensorFlow) for the module's runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    yield
    mp.undo()
    torch.set_num_threads(threads)


def test_runner_writes_q_plots_for_an_active_run_only(one_thread,
                                                      tmp_path):
    rc = tcfg.load_run_config(C.CONF)
    rc.runs_root, rc.epochs, rc.batch_size = str(tmp_path / "a"), 1, 2
    rc.synth_on_device = True
    rc.raw = dict(rc.raw, SYNTH_STEPS_PER_EPOCH=1, SYNTH_EVAL_SAMPLES=6)
    rc.model_cfg = BiEARConfig(n_bands=16, timesteps=3, latent_dim=16,
                               ctrl_hidden=16, deltaQ_mode="relative")
    out = trun.train(rc, synth=train_biear.make_synth(rc, "cpu"),
                     run_id="Q", quiet=True, device="cpu")
    q_dir = os.path.join(out["run_dir"], "q_vis")
    assert {"q_batch000.npz", "q_batch001.npz"} <= set(os.listdir(q_dir))
    npz = np.load(os.path.join(q_dir, "q_batch000.npz"))
    assert npz["QL"].shape == (1, 3, 16) and npz["Q0"].shape == (16,)

    shards = C.write_passive_shards(tmp_path / "p-shards")
    prc = C.run_config(False, tmp_path / "p", "passive", shards)
    prc.epochs = 1
    pout = trun.train(prc, quiet=True, seed=0, device="cpu")
    assert pout["test"] is not None
    assert os.listdir(os.path.join(pout["run_dir"], "q_vis")) == []


# ---------------- run_full_protocol and the post-hoc tools ----------------

def _tiny_config(tmp_path, name, src):
    text = open(os.path.join(REPO, "conf", src)).read()
    lines = [ln for ln in text.splitlines()
             if ln.split(":")[0].strip() not in TINY_YAML
             and not ln.startswith("RUNS_ROOT")]
    lines += [f"{k}: {v}" for k, v in TINY_YAML.items()]
    lines.append(f'RUNS_ROOT: "{tmp_path / "runs"}"')
    path = tmp_path / name
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def protocol_runs(one_thread, tmp_path_factory):
    """run_full_protocol on the tiny AuralNet config and on the tiny
    flagship with --fixed-q: {label: (argv, result)}."""
    tmp = tmp_path_factory.mktemp("protocol")
    runs = {}
    for label, src, extra in (
            ("auralnet", "config_auralnet_deepear.yaml", []),
            ("fixedq", "config.yaml", ["--fixed-q"])):
        argv = ["--config", _tiny_config(tmp, f"{label}.yaml", src),
                "--comments", label] + TINY_ARGS + extra
        runs[label] = (argv, run_full_protocol.main(argv))
    return runs


def _same(a, b) -> bool:
    """Equal as JSON (NaN, a sector mean over no row, equals NaN)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def _read(run_dir, name):
    with open(os.path.join(run_dir, f"evaluate_biear_metrics_{name}.json"),
              "rb") as f:
        return f.read()


@pytest.mark.parametrize("label", ["auralnet", "fixedq"])
def test_run_full_protocol_runs_end_to_end(protocol_runs, label):
    _, res = protocol_runs[label]
    run = res["run_dir"]
    with open(os.path.join(run, "meta", "settings.json")) as f:
        settings = json.load(f)
    assert settings["MODEL_KIND"] == ("auralnet" if label == "auralnet"
                                      else "active")
    assert settings["FIXED_FRONTEND_Q"] is True
    assert len(res["history"]["train"]) == 1
    for name in ("test1", "test2"):
        metrics = json.loads(_read(run, name))
        assert set(metrics) == SPLITS and _same(metrics, res[name])
        o = metrics["overall"]
        assert 0.0 <= o["sound_acc"] <= 1.0 and np.isfinite(o["aoa_mae"])
        assert res["test_ms"][name] > 0
    assert not _same(res["test1"], res["test2"])
    assert os.path.exists(os.path.join(run, "logs_json",
                                       "test_metrics.json"))
    # the Q plots: the active model's (constant under fixed Q), not
    # AuralNet's
    q_vis = os.listdir(os.path.join(run, "q_vis"))
    assert ("q_batch000.npz" in q_vis) == (label == "fixedq")


def test_protocol_eval_reproduces_run_full_protocol(protocol_runs):
    """The JAX tool's flags plus the protocol run's corpus, noise and
    sizes: the same seeds give the same splits, and the best checkpoint
    the same predictions, so both files come back byte for byte."""
    _, res = protocol_runs["auralnet"]
    run = res["run_dir"]
    before = {n: _read(run, n) for n in ("test1", "test2")}
    for n in before:
        os.remove(os.path.join(run, f"evaluate_biear_metrics_{n}.json"))
    out = protocol_eval.main([run, "--corpus", "speech", "--noise-snr",
                              "5,25", "--eval-size", "12", "--pool-size",
                              "6", "--device", "cpu", "--quiet"])
    for n, text in before.items():
        assert _read(run, n) == text, n
        assert _same(out[n], json.loads(text))


def test_eval_by_snr_slices_both_runs(protocol_runs, tmp_path):
    dirs = [protocol_runs[k][1]["run_dir"] for k in ("auralnet", "fixedq")]
    out = str(tmp_path / "snr.json")
    res = eval_by_snr.main(dirs + ["--snrs", "5,25", "--eval-size", "12",
                                   "--pool-size", "6", "--out", out,
                                   "--device", "cpu", "--quiet"])
    with open(out) as f:
        assert _same(json.load(f), res)
    assert res["split_seed_offset"] == 888 and res["eval_size"] == 12
    labels = [os.path.basename(d) for d in dirs]
    assert sorted(res["runs"]) == sorted(labels)
    for label in labels:
        assert set(res["runs"][label]) == {"5dB", "25dB", "clean"}
        for m in res["runs"][label].values():
            assert set(m) == {"sound_acc", "aoa_mae_deg_masked", "dist_acc"}
            assert 0.0 <= m["sound_acc"] <= 1.0
    assert eval_by_snr.find_checkpoint(dirs[0]).endswith(
        os.path.join("checkpoints", "best", "params.pth"))


def test_run_full_protocol_resumes_a_run(protocol_runs, tmp_path):
    """--resume continues a copy of the AuralNet run from checkpoints/last
    for a second epoch, then scores test1 / test2 again."""
    argv, res = protocol_runs["auralnet"]
    run = str(tmp_path / os.path.basename(res["run_dir"]))
    shutil.copytree(res["run_dir"], run)
    for n in ("test1", "test2"):
        os.remove(os.path.join(run, f"evaluate_biear_metrics_{n}.json"))
    argv = list(argv)
    argv[argv.index("--epochs") + 1] = "2"
    out = run_full_protocol.main(argv + ["--resume", run])
    assert out["run_dir"] == run and len(out["history"]["train"]) == 2
    for n in ("test1", "test2"):
        assert set(json.loads(_read(run, n))) == SPLITS
