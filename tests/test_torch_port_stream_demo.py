"""The port's streaming demo and run archiver held against the JAX package
and the JAX tools (CPU).

  * ``stream_demo.stream_beliefs`` against JAX's ``stream_step`` /
    ``stream_readout`` loop of ``tools/stream_demo.py`` on the same
    waveforms: per hop to 2e-4 (tests/test_streaming.py's tolerance) on
    seeded weights at a small width, and on docs/protocol_r3/flagship-s1
    at full width, where the limit is the larger of 2e-4 and JAX's own
    change under 1e-6 relative waveform noise (the trained checkpoints
    are ill-conditioned at the rounding level,
    tests/test_torch_port_evaluate.py);
  * the demo on the CPU: the JAX tool's JSON fields, the figure where
    matplotlib imports and a log line where it does not, outputs under
    runs_demo/ by default;
  * ``archive_protocol_run`` on a tiny protocol run of the port: the
    metric files byte-copied, the exported best.pth loading strictly into
    the port's AuralNet and through JAX's ``load_params`` /
    ``import_auralnet``, and a failed export exiting with an error after
    the metric files are copied.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biear_tpu.config import config_from_settings as jax_settings_config
from biear_tpu.models import BiEARConfig as JaxConfig
from biear_tpu.models.biear import init_active
from biear_tpu.serve import (stream_init as jinit, stream_plan as jplan,
                             stream_readout as jreadout, stream_step as jstep)
from biear_tpu.train.evaluate import load_params

from biear_tpu_torch import archive_protocol_run, run_full_protocol
from biear_tpu_torch import stream_demo
from biear_tpu_torch.config import config_from_settings
from biear_tpu_torch.models import ActiveBiEAR, AuralNet, BiEARConfig
from biear_tpu_torch.models.weights import state_dict_from_jax
from biear_tpu_torch.serve.infer import load_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHIVE = os.path.join(REPO, "docs", "protocol_r3", "flagship-s1")
STREAM_ATOL = 2e-4
FLAGSHIP = dict(deltaQ_mode="relative", deltaQ_base=1.0,
                deltaQ_low_factor=0.3, deltaQ_high_factor=5.0)
NARROW = dict(FLAGSHIP, fs=1600, timesteps=4, n_fft=256, n_bands=100,
              fmin=50.0, fmax=700.0, latent_dim=16, ctrl_hidden=16)
JSON_KEYS = ["archive", "n_src", "seed", "gt_sectors", "pred_sectors",
             "settled_at_hop", "settled_at_s", "hop_s", "probs_per_hop"]


def jax_beliefs(params, cfg, wavL, wavR):
    """tools/stream_demo.py's loop: stream_step per hop, the readout after
    each, the residual tail at the last; (T, 8) probabilities of stream 0."""
    plan = jplan(cfg)
    hop, T = plan["hop"], cfg.timesteps
    state = jinit(params, cfg, wavL.shape[0])
    step = jax.jit(jstep, static_argnums=1)
    probs = []
    with jax.default_matmul_precision("highest"):
        for t in range(T):
            sl = slice(t * hop, (t + 1) * hop)
            state = step(params, cfg, state, jnp.asarray(wavL[:, sl]),
                         jnp.asarray(wavR[:, sl]))
            tail = ((jnp.asarray(wavL[:, T * hop:]),
                     jnp.asarray(wavR[:, T * hop:])) if t == T - 1
                    else (None, None))
            sound = jreadout(params, cfg, state, *tail)[0]
            probs.append(np.asarray(jax.nn.sigmoid(sound))[0])
    return np.stack(probs)


@pytest.mark.parametrize("mode", ["dual", "single"])
def test_stream_beliefs_match_jax_on_seeded_weights(mode):
    kw = dict(NARROW, controller_mode=mode)
    cfg_j, cfg_t = JaxConfig(**kw), BiEARConfig(**kw)
    params = init_active(jax.random.PRNGKey(3), cfg_j)
    p = params["bifb"]["fb" if mode == "dual" else "ctrl"]
    p["q_out"]["l3"]["w"] = 0.25 * jax.random.normal(
        jax.random.PRNGKey(7), p["q_out"]["l3"]["w"].shape)
    model = ActiveBiEAR(cfg_t)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), cfg_t), strict=True)
    rng = np.random.default_rng(11)
    t = np.arange(cfg_t.fs) / cfg_t.fs
    wavL = (0.3 * rng.standard_normal((2, cfg_t.fs))
            + np.sin(2 * np.pi * 300.0 * t)).astype(np.float32)
    wavR = np.roll(wavL, 5, axis=1).astype(np.float32)
    got = stream_demo.stream_beliefs(model, wavL, wavR)
    want = jax_beliefs(params, cfg_j, wavL, wavR)
    assert got.shape == want.shape == (cfg_t.timesteps, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=STREAM_ATOL)


def test_stream_beliefs_match_jax_on_the_trained_checkpoint():
    with open(os.path.join(ARCHIVE, "settings.json")) as f:
        settings = json.load(f)
    cfg_t = config_from_settings(settings)
    model = load_model(os.path.join(ARCHIVE, "best.pth"), cfg_t, "cpu")
    wavL, wavR, gt = stream_demo.demo_scene(cfg_t, 2, 4, pool_size=8,
                                            device="cpu")
    assert len(gt) == 2
    wavL, wavR = wavL.numpy(), wavR.numpy()
    cfg_j = jax_settings_config(settings)[0]
    params = load_params(os.path.join(ARCHIVE, "best.pth"), cfg_j)
    got = stream_demo.stream_beliefs(model, wavL, wavR)
    want = jax_beliefs(params, cfg_j, wavL, wavR)
    assert got.shape == want.shape == (19, 8)
    noise = np.random.default_rng(5).standard_normal((2,) + wavL.shape)
    wit = jax_beliefs(params, cfg_j,
                      (wavL * (1 + 1e-6 * noise[0])).astype(np.float32),
                      (wavR * (1 + 1e-6 * noise[1])).astype(np.float32))
    tol = max(STREAM_ATOL, float(np.abs(wit - want).max()))
    assert float(np.abs(got - want).max()) <= tol
    assert (stream_demo.settled_hop(got, gt)
            == stream_demo.settled_hop(want, gt))


def test_settled_hop():
    p = np.zeros((5, 8))
    p[:, 1] = [0.9, 0.2, 0.8, 0.9, 0.95]
    assert stream_demo.settled_hop(p, [1]) == 2
    assert stream_demo.settled_hop(p, [2]) is None
    p[4, 1] = 0.1
    assert stream_demo.settled_hop(p, [1]) is None


@pytest.mark.parametrize("matplotlib", [True, False])
def test_stream_demo_writes_the_tools_fields(matplotlib, tmp_path,
                                             monkeypatch, capsys):
    """With matplotlib, the default outputs land under runs_demo/ of the
    working directory; without it, no figure and a log line."""
    monkeypatch.chdir(tmp_path)
    argv = ["--archive", ARCHIVE, "--pool-size", "8", "--device", "cpu"]
    js, png = (os.path.join("runs_demo", "stream_demo." + ext)
               for ext in ("json", "png"))
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        js, png = "d.json", "d.png"
        argv += ["--json", js, "--png", png]
    out = stream_demo.main(argv)
    with open(js) as f:
        saved = json.load(f)
    assert list(saved) == JSON_KEYS and saved == json.loads(json.dumps(out))
    assert len(saved["probs_per_hop"]) == 19
    assert saved["hop_s"] == 0.0526 and saved["n_src"] == 2
    assert os.path.exists(png) == matplotlib
    said = capsys.readouterr().out
    assert ("matplotlib is not installed" in said) != matplotlib


# ---------------- archive_protocol_run ----------------

@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A one-epoch protocol run of a narrow AuralNet on the CPU."""
    root = tmp_path_factory.mktemp("runs")
    conf = root / "a.yaml"
    text = open(os.path.join(REPO, "conf",
                             "config_auralnet_deepear.yaml")).read()
    for key, val in (("BATCH_SIZE", "4"), ("N_BANDS", "16"),
                     ("TIMESTEPS", "3"), ("D_MODEL", "32")):
        text = "\n".join(f"{key}: {val}" if line.startswith(f"{key}:")
                         else line for line in text.splitlines())
    conf.write_text(text)
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = run_full_protocol.main(
            ["--config", str(conf), "--device", "cpu", "--corpus", "speech",
             "--noise-snr", "5,25", "--train-size", "8", "--eval-size",
             "12", "--pool-size", "8", "--epochs", "1", "--runs-root",
             str(root), "--quiet"])
    finally:
        torch.set_num_threads(threads)
        mp.undo()
    return res["run_dir"]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_archive_copies_the_metrics_and_exports_a_strict_checkpoint(
        tiny_run, tmp_path):
    out = archive_protocol_run.main([tiny_run, "lab", "--dest",
                                     str(tmp_path)])
    for rel in ("evaluate_biear_metrics_test1.json",
                "evaluate_biear_metrics_test2.json",
                "logs_json/test_metrics.json", "meta/settings.json",
                "logs_json/history.json"):
        assert _read(os.path.join(out, os.path.basename(rel))) == _read(
            os.path.join(tiny_run, rel)), rel
    with open(os.path.join(out, "history_summary.json")) as f:
        assert json.load(f)["epochs"] == 1
    with open(os.path.join(out, "settings.json")) as f:
        settings = json.load(f)
    sd = torch.load(os.path.join(out, "best.pth"), weights_only=True)
    assert any(".self_attn.in_proj_weight" in k for k in sd)
    model = AuralNet(config_from_settings(settings))
    model.load_state_dict(sd, strict=True)
    best = torch.load(os.path.join(tiny_run, "checkpoints", "best",
                                   "params.pth"), weights_only=True)
    assert set(sd) == set(best)
    assert all(torch.equal(sd[k], best[k]) for k in sd)
    cfg_j = jax_settings_config(settings)[0]
    params = load_params(os.path.join(out, "best.pth"), cfg_j, "auralnet")
    back = state_dict_from_jax(jax.tree.map(np.asarray, params),
                               config_from_settings(settings))
    assert all(np.array_equal(back[k].numpy(), sd[k].numpy()) for k in back)
    assert set(back) <= set(sd)


def test_archive_export_failure_exits_after_the_metrics(tiny_run, tmp_path):
    import shutil
    run = str(tmp_path / "run")
    shutil.copytree(tiny_run, run)
    pth = os.path.join(run, "checkpoints", "best", "params.pth")
    sd = torch.load(pth, weights_only=True)
    del sd[next(k for k in sd if "in_proj_weight" in k)]
    torch.save(sd, pth)
    with pytest.raises(RuntimeError, match="in_proj_weight"):
        archive_protocol_run.main([run, "bad", "--dest", str(tmp_path)])
    assert os.path.exists(str(tmp_path / "bad" /
                              "evaluate_biear_metrics_test1.json"))
    assert not os.path.exists(str(tmp_path / "bad" / "best.pth"))
    os.remove(pth)
    with pytest.raises(FileNotFoundError, match="no best checkpoint"):
        archive_protocol_run.main([run, "none", "--dest", str(tmp_path)])
    archive_protocol_run.main([run, "skip", "--dest", str(tmp_path),
                               "--no-checkpoint"])
    assert sorted(os.listdir(str(tmp_path / "skip"))) == [
        "evaluate_biear_metrics_test1.json",
        "evaluate_biear_metrics_test2.json", "history.json",
        "history_summary.json", "settings.json", "test_metrics.json"]
