"""MATMUL_PRECISION in the PyTorch port, held against the JAX package (CPU).

The six names of ``biear_tpu/config.py::apply_matmul_precision`` load,
apply and are recorded as in JAX; ``device.matmul_precision`` sets the TF32
flags and the CUDA autocast of each name and restores them; on the CPU
every name computes the same bits (only CUDA state is touched, and
XLA:CPU ignores the knob too), so the port under each name is held to JAX
under the same name at the limits of tests/test_torch_port_model.py
(forward: 2e-3, Q 5e-3) and tests/test_torch_port_train.py (one step:
loss 5e-5, parameters 3e-3); the runner, ``evaluate`` and the serving CLI
run under the settings' name. The card's numbers under each name are
held in ``chip_smoke.py`` phase 17.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from biear_tpu import config as jcfg
from biear_tpu.models import BiEARConfig as JaxConfig
from biear_tpu.models import active_forward
from biear_tpu.models.biear import init_active
from biear_tpu.train import loop as jloop
from biear_tpu.train import optim as jopt

import _torch_runner_common as C
from biear_tpu_torch import config as tcfg
from biear_tpu_torch import device as tdev
from biear_tpu_torch.models import ActiveBiEAR, BiEARConfig
from biear_tpu_torch.models.weights import state_dict_from_jax
from biear_tpu_torch.serve import infer as tinfer
from biear_tpu_torch.train import evaluate as tev
from biear_tpu_torch.train import loop as tloop
from biear_tpu_torch.train import optim as topt
from biear_tpu_torch.train import runner as trun

NAMES = tdev.PRECISION_NAMES
TINY = dict(fs=1600, timesteps=4, n_fft=256, n_bands=24, fmin=50.0,
            fmax=700.0, latent_dim=24, controller_mode="dual",
            deltaQ_mode="relative", ctrl_dropout=0.0, backend_dropout=0.0)
FWD_TOL, Q_TOL = 2e-3, 5e-3          # tests/test_torch_port_model.py
LOSS_TOL, PARAM_TOL = 5e-5, 3e-3     # tests/test_torch_port_train.py


@pytest.fixture(autouse=True)
def _restore_policies():
    """Both packages' process-wide policies, as each test found them."""
    prev_j = jax.config.jax_default_matmul_precision
    prev_t = tdev.matmul_precision_name()
    yield
    jax.config.update("jax_default_matmul_precision",
                      prev_j if prev_j is not None else "default")
    tdev.apply_matmul_precision(prev_t)


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.is_autocast_enabled("cuda"),
            tdev.matmul_precision_name())


def _fake_card(monkeypatch):
    """Let CUDA autocast switch on in a CPU build (it acts on CUDA tensors
    only, so CPU results do not move)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_bf16_supported",
                        lambda *a, **k: True)


# ---------------- names ----------------

@pytest.mark.parametrize("name", NAMES)
def test_name_loads_applies_and_is_recorded(name, tmp_path):
    with open(C.CONF) as f:
        raw = yaml.safe_load(f)
    raw["MATMUL_PRECISION"] = name.upper()
    p = tmp_path / "c.yaml"
    p.write_text(yaml.safe_dump(raw))
    rc_t, rc_j = tcfg.load_run_config(str(p)), jcfg.load_run_config(str(p))
    assert rc_t.matmul_precision == rc_j.matmul_precision == name
    s_t = tcfg.settings_dict(rc_t, "R", "E")
    assert s_t["MATMUL_PRECISION"] == name
    assert s_t["MATMUL_PRECISION"] == jcfg.settings_dict(
        rc_j, "R", "E")["MATMUL_PRECISION"]
    assert (tdev.apply_matmul_precision(name.upper())
            == jcfg.apply_matmul_precision(name.upper()) == name)
    assert tdev.matmul_precision_name() == name
    assert trun.check_supported(rc_t) == (1, 1)


def test_unknown_name_raises_as_in_jax():
    for apply in (tdev.apply_matmul_precision, jcfg.apply_matmul_precision):
        with pytest.raises(ValueError, match="MATMUL_PRECISION"):
            apply("fp8")
    with pytest.raises(ValueError, match="MATMUL_PRECISION"):
        with tdev.matmul_precision("fast"):
            pass
    rc = tcfg.load_run_config(C.CONF)
    rc.matmul_precision = "fast"
    with pytest.raises(ValueError, match="MATMUL_PRECISION"):
        trun.check_supported(rc)
    assert tdev.matmul_precision_name() == "default"


# ---------------- flags and autocast ----------------

@pytest.mark.parametrize("name", NAMES)
def test_flags_and_autocast_per_name_are_restored(name, monkeypatch):
    """Inside the block: TF32 on exactly for "high" / "tensorfloat32",
    bf16 autocast exactly for "bfloat16", the name as the process-wide
    policy; a nested HIGHEST pin turns both off. Everything comes back on
    exit, after an error too."""
    _fake_card(monkeypatch)
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True   # a state to restore
        torch.backends.cudnn.allow_tf32 = False
        before = _flags()
        tf32 = name in ("high", "tensorfloat32")
        with tdev.matmul_precision(name):
            assert _flags() == (tf32, tf32, name == "bfloat16", name)
            if name == "bfloat16":
                assert torch.get_autocast_dtype("cuda") == torch.bfloat16
            with tdev.precision_highest():
                assert _flags() == (False, False, False, name)
            assert _flags() == (tf32, tf32, name == "bfloat16", name)
            with tdev.matmul_precision():              # the active policy
                assert _flags() == (tf32, tf32, name == "bfloat16", name)
        assert _flags() == before
        with pytest.raises(KeyError):
            with tdev.matmul_precision(name):
                raise KeyError("inside")
        assert _flags() == before
        tdev.apply_matmul_precision(name)
        with tdev.matmul_precision():
            assert _flags()[3] == name and _flags()[0] == tf32
        assert _flags()[:3] == before[:3]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def test_gru_takes_the_cell_loop_only_under_bf16_autocast(monkeypatch):
    """``layers.GRU`` runs ``nn.GRU`` unless the bf16 policy's autocast is
    on for the input's device (a CPU tensor never is); its loop of
    ``step`` cells, forced here in f32, equals ``nn.GRU``."""
    from biear_tpu_torch.models import layers
    gru = layers.GRU(6, 5)
    x = torch.randn(2, 4, 6, generator=torch.Generator().manual_seed(0))
    _fake_card(monkeypatch)
    with tdev.matmul_precision("bfloat16"):
        assert not tdev.autocast_bf16(x)
    seq, last = torch.nn.GRU.forward(gru, x)
    monkeypatch.setattr(layers, "autocast_bf16", lambda t: True)
    loop_seq, loop_last = gru(x)
    torch.testing.assert_close(loop_seq, seq, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(loop_last, last, rtol=1e-6, atol=1e-6)


# ---------------- numbers: CPU bits and JAX parity ----------------

def _pair(seed=0):
    cfg_j, cfg_t = JaxConfig(**TINY), BiEARConfig(**TINY)
    params = init_active(jax.random.PRNGKey(seed), cfg_j)
    rng = np.random.default_rng(seed)
    l3 = params["bifb"]["fb"]["q_out"]["l3"]           # Q really adapts
    l3["w"] = jnp.asarray(rng.uniform(-0.05, 0.05, l3["w"].shape),
                          jnp.float32)
    l3["b"] = jnp.asarray(rng.uniform(-0.05, 0.05, l3["b"].shape),
                          jnp.float32)
    params = jax.tree.map(np.asarray, params)
    model = ActiveBiEAR(cfg_t)
    model.load_state_dict(state_dict_from_jax(params, cfg_t), strict=True)
    return cfg_j, params, model


def _batch(seed, cfg, B=3):
    rng = np.random.default_rng(seed)
    wav = rng.uniform(-1, 1, (2, B, cfg.fs)).astype(np.float32)
    x3 = rng.uniform(-1, 1, (B, cfg.n_bands)).astype(np.float32)
    y = np.zeros((B, 8, 7), np.float32)
    y[:, :, 2] = 1.0
    for b in range(B):
        s = rng.integers(0, 8)
        y[b, s, :3] = (1.0, rng.uniform(), 0.0)
        y[b, s, 3 + rng.integers(0, 4)] = 1.0
    return wav[0], wav[1], x3, y.reshape(B, 56)


def _port_step(model, batch):
    """One port train step from a copy of `model`: (loss, state dict)."""
    m = ActiveBiEAR(model.cfg)
    m.load_state_dict(model.state_dict())
    hp = topt.TrainHyper()
    out = tloop.train_step(m, hp, topt.make_optimizer(m, hp),
                           tuple(torch.as_tensor(a) for a in batch),
                           torch.Generator())
    assert float(out["skipped"]) == 0.0
    return float(out["loss"]), m.state_dict()


def test_cpu_numbers_are_the_same_under_every_name():
    _, _, model = _pair(1)
    batch = _batch(1, model.cfg)
    x = [torch.as_tensor(a) for a in batch[:3]]
    ref = None
    for name in ("highest",) + NAMES:
        with tdev.matmul_precision(name):
            with torch.no_grad():
                fwd = model(*x)
            loss, sd = _port_step(model, batch)
        got = (list(fwd[:3]) + [fwd[3]["Q"]], loss, sd)
        if ref is None:
            ref = got
            continue
        for a, b in zip(got[0], ref[0]):
            assert torch.equal(a, b), name
        assert got[1] == ref[1], name
        for k in sd:
            assert torch.equal(got[2][k], ref[2][k]), (name, k)


@pytest.mark.parametrize("name", NAMES)
def test_forward_and_step_match_jax_under_each_name(name):
    cfg_j, params, model = _pair(2)
    batch = _batch(2, cfg_j)
    jcfg.apply_matmul_precision(name)
    want = jax.jit(lambda p, a, b, c: active_forward(
        p, cfg_j, a, b, c, train=False))(
        params, *(jnp.asarray(a) for a in batch[:3]))
    hp = topt.TrainHyper()
    opt = jopt.make_optimizer(params, hp)
    params_j, _, m = jloop.make_train_step(cfg_j, hp, opt, "active")(
        jax.tree.map(jnp.asarray, params), opt.init(params),
        tuple(jnp.asarray(a) for a in batch), jax.random.PRNGKey(0),
        jnp.float32(1.0))
    with tdev.matmul_precision(name):
        with torch.no_grad():
            got = model(*(torch.as_tensor(a) for a in batch[:3]))
        loss, sd = _port_step(model, batch)
    for label, g, w in zip(("sound", "aoa", "dist"), got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FWD_TOL,
                                   rtol=1e-3, err_msg=label)
    q = got[3]["Q"].numpy()
    np.testing.assert_allclose(q, np.asarray(want[3]["Q"]), atol=Q_TOL,
                               rtol=FWD_TOL)
    assert np.abs(q[:, 1:] - q[:, :1]).max() > 1e-4      # Q adapts
    assert abs(loss - float(m["loss"])) < LOSS_TOL
    want_sd = state_dict_from_jax(jax.tree.map(np.asarray, params_j),
                                  model.cfg)
    diff = max(float((sd[k] - want_sd[k]).abs().max()) for k in want_sd)
    assert diff < PARAM_TOL


# ---------------- entry points apply the settings' name ----------------

def test_runner_evaluate_and_serving_cli_apply_the_name(tmp_path, capsys,
                                                        monkeypatch):
    """A run with MATMUL_PRECISION "bfloat16" records it in settings.json,
    logs it and trains under it; evaluate and the serving CLI on its best
    checkpoint run their forwards under it; afterwards the process-wide
    policy is back to what it was."""
    seen = []

    def spy(fn):
        def wrapped(*a, **k):
            seen.append((fn.__name__, tdev.matmul_precision_name()))
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tloop, "train_step", spy(tloop.train_step))
    monkeypatch.setattr(tev, "collect_predictions",
                        spy(tev.collect_predictions))
    monkeypatch.setattr(tinfer, "predict", spy(tinfer.predict))
    rc = C.run_config(False, tmp_path, "two-group")
    rc.epochs, rc.matmul_precision = 1, "bfloat16"
    # settings.json does not record the controller's width: keep its default
    rc.model_cfg = BiEARConfig(**dict(C.SMALL, ctrl_hidden=128))
    ds = C.dataset()
    with C.small_cpu():
        out = trun.train(rc, datasets={"train": ds, "val": ds}, run_id="P",
                         device="cpu")
    assert "[Precision] MATMUL_PRECISION=bfloat16" in capsys.readouterr().out
    with open(os.path.join(out["run_dir"], "meta", "settings.json")) as f:
        assert json.load(f)["MATMUL_PRECISION"] == "bfloat16"
    assert tdev.matmul_precision_name() == "default"
    best = os.path.join(out["run_dir"], "checkpoints", "best")
    tev.evaluate(best, dataset=ds, batch_size=5, device="cpu",
                 out_path=str(tmp_path / "m.json"))
    from scipy.io import wavfile
    wav = str(tmp_path / "a.wav")
    wavfile.write(wav, rc.model_cfg.fs,
                  np.stack(ds.arrays[0][:2]).T.astype(np.float32))
    tinfer.main(["--checkpoint", os.path.join(best, "params.pth"),
                 "--device", "cpu", "--out", str(tmp_path / "p.jsonl"), wav])
    assert {fn for fn, _ in seen} == {"train_step", "collect_predictions",
                                      "predict"}
    assert all(name == "bfloat16" for _, name in seen), seen
    assert tdev.matmul_precision_name() == "default"
