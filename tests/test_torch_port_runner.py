"""The port's training runner held against the JAX runner (CPU).

One in-memory dataset (12 rows made from a seed with numpy, batch 4,
dropout 0, f32) goes through JAX ``train`` for 2 epochs with two
optimizer groups (the fixed-Q and frozen-controller shapes run in
tests/test_torch_port_config.py, on another worker). Inside that run
the test captures JAX's initial parameters and Adam state and a copy of
its ``last`` checkpoint after epoch 1 (parameters and optax state, read
back through orbax and turned into numpy). ``state_dict_from_jax`` and
``adam_state_from_optax`` turn either into a port checkpoint, and the
port's ``train(device="cpu")`` resumes from it:

  * from the initial state (two groups) it trains both epochs: per-epoch
    train and val losses within 5e-5 of JAX's and the final parameters
    within 3e-3, the limits of the 3-step trajectory test
    (tests/test_torch_port_train.py);
  * from epoch 1's checkpoint (non-zero moments and counts) it trains
    epoch 2 to the same limits. JAX's own resume from that checkpoint is
    held to its uninterrupted run, so the comparison is with JAX's resume.

The best epoch is compared only where JAX's validation tuples are not
tied within the loss tolerance. On the synthesised path (port only) two
epochs straight equal one epoch and a resume, bit for bit. Checkpoints
round-trip exactly, and ``evaluate`` reads a runner checkpoint directory
(the JAX evaluator reads its ``params.pth`` too).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from biear_tpu.models.config import BiEARConfig as JaxConfig
from biear_tpu.train import runner as jrun
from biear_tpu.utils import torch_import as ti

from biear_tpu_torch import config as tcfg
from biear_tpu_torch import train_biear
from biear_tpu_torch.models import ActiveBiEAR, BiEARConfig
from biear_tpu_torch.models.weights import state_dict_from_jax
from biear_tpu_torch.train import evaluate as tev
from biear_tpu_torch.train import optim as topt
from biear_tpu_torch.train import runner as trun
from biear_tpu_torch.train import state as tstate

import _torch_runner_common as C
from _torch_runner_common import SMALL, SEED, LOSS_TOL


@pytest.fixture(scope="module")
def small_cpu():
    with C.small_cpu():
        yield


@pytest.fixture(scope="module")
def jax_run(small_cpu, tmp_path_factory):
    return C.jax_run("two-group", tmp_path_factory.mktemp("jax_runs"))


def best_epoch(run_dir):
    with open(os.path.join(run_dir, "checkpoints", "best", "meta.json")) as f:
        return json.load(f)["epoch"]


def test_adam_state_from_optax_reads_two_groups(jax_run):
    C.check_adam_conversion("two-group", jax_run)


def test_runner_matches_jax_from_jax_initial_state(jax_run, tmp_path):
    """Both runners start from JAX's initial state and train the same 2
    epochs on the same batches."""
    run = jax_run
    rc = C.run_config(False, tmp_path, "two-group")
    params_np, opt_np = run["init"]
    out = C.port_train(rc, C.port_run_from(tmp_path, params_np, opt_np,
                                           {"epoch": 0}, rc.model_cfg))
    C.assert_losses(out["history"], run["history"], (0, 1))
    p2, _, meta = C.restore_jax(run, os.path.join(
        run["run_dir"], "checkpoints", "last"))
    C.assert_params(out["model"], p2)
    assert out["global_step"] == meta["global_step"] == 6
    assert all(int(g.count) == 6 for g in out["optimizer"].groups)
    # the best epoch, where JAX's val tuples are not tied within tolerance
    va = [tuple(v[k] for k in ("sound_acc", "aoa_mae", "dist_acc"))
          for v in run["history"]["val"]]
    if any(abs(a - b) > LOSS_TOL for a, b in zip(*va)):
        assert best_epoch(out["run_dir"]) == best_epoch(run["run_dir"])
    assert os.path.exists(os.path.join(out["run_dir"], "logs_json",
                                       "test_metrics.json"))


def test_port_resumes_a_jax_checkpoint(jax_run, tmp_path):
    C.check_port_resume("two-group", jax_run, tmp_path)


def test_jax_resume_equals_its_uninterrupted_run(jax_run, tmp_path):
    """The reference the resume tests compare with: JAX resumed from its
    own epoch-1 checkpoint equals its uninterrupted run (the epoch's
    shuffle is keyed by seed and epoch, dropout is off, and the optimizer
    and plateau state are restored)."""
    run = jax_run
    rc = C.run_config(True, tmp_path, "two-group")
    resume = tmp_path / "jres"
    shutil.copytree(run["last1"], resume / "checkpoints" / "last")
    (resume / "logs_json").mkdir()
    (resume / "logs_json" / "history.json").write_text(json.dumps(
        {k: v[:1] for k, v in run["history"].items()}))
    with jax.default_matmul_precision("highest"):
        res = jrun.train(rc, datasets=C.splits(), quiet=True, seed=SEED,
                         resume_from=str(resume))
    for split in ("train", "val"):
        assert res["history"][split][1]["loss"] == pytest.approx(
            run["history"][split][1]["loss"], abs=1e-6)
    p_res, _, _ = C.restore_jax(run, str(resume / "checkpoints" / "last"))
    p_run, _, _ = C.restore_jax(run, os.path.join(run["run_dir"],
                                                "checkpoints", "last"))
    for a, b in zip(jax.tree.leaves(p_res), jax.tree.leaves(p_run)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def _synth_rc(tmp_path, epochs, chunk_cfg=2):
    rc = tcfg.load_run_config(C.CONF)
    rc.runs_root, rc.epochs, rc.batch_size = str(tmp_path), epochs, 2
    rc.synth_on_device, rc.print_every, rc.hist_every = True, 1, 1
    rc.raw = dict(rc.raw, SYNTH_STEPS_PER_EPOCH=3, SYNTH_CHUNK_STEPS=chunk_cfg,
                  SYNTH_EVAL_SAMPLES=5)
    rc.model_cfg = BiEARConfig(n_bands=16, timesteps=3, latent_dim=16,
                               ctrl_hidden=16, deltaQ_mode="relative")
    return rc


def _check_synth_resume(tmp_path, chunk_cfg):
    """Two epochs straight equal one epoch and a resume, bit for bit; the
    telemetry marks of every step are logged from the chunks."""
    runs = {}
    for name, stages in (("straight", (2,)), ("resumed", (1, 2))):
        rc = _synth_rc(tmp_path / name, stages[0], chunk_cfg)
        synth = train_biear.make_synth(rc, "cpu")
        out = trun.train(rc, synth=synth, run_id="S", quiet=True,
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
    sa, sb = a["optimizer"].state_dict(), b["optimizer"].state_dict()
    for label in sa:
        assert torch.equal(sa[label]["count"], sb[label]["count"])
        for key in ("m", "v"):
            for n in sa[label][key]:
                assert torch.equal(sa[label][key][n], sb[label][key][n])
    for split in ("train", "val"):
        strip = lambda h: [{k: v for k, v in e.items() if k != "sec"}
                           for e in h[split]]
        assert strip(a["history"]) == strip(b["history"])
    assert a["test"]["loss"] == b["test"]["loss"]
    lines = [json.loads(s) for s in open(os.path.join(
        a["run_dir"], "logs_json", "scalars.jsonl"))]
    steps = sorted(r["step"] for r in lines if "train_step/loss" in r)
    assert steps == list(range(6))
    hist = [r for r in lines if r.get("kind") == "hist"]
    assert len(hist) == 6 and "grads/bifb.fb_L.q_rnn.weight_ih_l0" in hist[0]


def test_synthesised_run_resumes_bit_identically(small_cpu, tmp_path):
    """Dropout on; 3 steps per epoch in chunks of 2 and 1."""
    _check_synth_resume(tmp_path, 2)


def test_synthesised_per_step_run_resumes_bit_identically(small_cpu,
                                                          tmp_path):
    """SYNTH_CHUNK_STEPS 0 (the JAX runner's per-step synthesised path):
    chunks of one step, each keyed by (seed, epoch, step)."""
    _check_synth_resume(tmp_path, 0)


def test_checkpoint_round_trip_is_exact(small_cpu, tmp_path):
    cfg = BiEARConfig(**SMALL)
    batch = tuple(torch.tensor(a) for a in C.dataset(3).rows(np.arange(4)))
    hp = topt.TrainHyper()
    from biear_tpu_torch.train.loop import train_step
    model = ActiveBiEAR(cfg).init_weights_(1)
    opt = topt.make_optimizer(model, hp)
    train_step(model, hp, opt, batch, torch.Generator())
    tstate.save_checkpoint(str(tmp_path / "ck"), model, opt, {"epoch": 4})
    fresh = ActiveBiEAR(cfg).init_weights_(7)
    fopt = topt.make_optimizer(fresh, hp)
    meta = tstate.load_checkpoint(str(tmp_path / "ck"), fresh, fopt)
    assert meta == {"epoch": 4}
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k
    for ga, gb in zip(opt.groups, fopt.groups):
        assert torch.equal(ga.count, gb.count) and int(ga.count) == 1
        for a, b in zip(ga.m + ga.v, gb.m + gb.v):
            assert torch.equal(a, b)
    # the reference-format params.pth: the JAX importer reads it back
    sd = ti.load_state_dict(str(tmp_path / "ck" / "params.pth"))
    back = state_dict_from_jax(C.to_np(ti.import_active(sd, JaxConfig(**SMALL))),
                               cfg)
    for k, v in back.items():
        assert torch.equal(v, model.state_dict()[k]), k
    with pytest.raises(ValueError, match="groups"):
        fopt.load_state_dict({"backend": opt.state_dict()["backend"]})


def test_evaluate_reads_a_runner_checkpoint(small_cpu, tmp_path):
    """The port's evaluate on a run's checkpoints/best directory (settings
    found by walking up to the run's meta/settings.json) equals evaluate
    on its params.pth with those settings. The controller keeps its
    default width: settings.json does not record it."""
    rc = C.run_config(False, tmp_path, "two-group")
    rc.epochs = 1
    rc.model_cfg = BiEARConfig(**dict(SMALL, ctrl_hidden=128))
    ds = C.dataset()
    out = trun.train(rc, datasets={"train": ds, "val": ds}, run_id="E",
                     quiet=True, device="cpu")
    assert out["test"] is None
    best = os.path.join(out["run_dir"], "checkpoints", "best")
    got = tev.evaluate(best, dataset=ds, batch_size=5, device="cpu")
    with open(os.path.join(out["run_dir"], "evaluate_biear_metrics.json")) as f:
        assert json.load(f).keys() == got.keys()
    with open(os.path.join(out["run_dir"], "meta", "settings.json")) as f:
        settings = json.load(f)
    want = tev.evaluate(os.path.join(best, "params.pth"), settings=settings,
                        dataset=ds, batch_size=5, device="cpu",
                        out_path=str(tmp_path / "m.json"))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert set(got) >= {"overall", "1spk"}


def test_train_cli_runs_on_the_cpu(small_cpu, tmp_path, monkeypatch):
    """python -m biear_tpu_torch.train_biear --device cpu on a small
    synthesised config; without --device and without a card it raises."""
    text = open(C.CONF).read()
    for old, new in (('RUNS_ROOT: "runs_biear"', f'RUNS_ROOT: "{tmp_path}/runs"'),
                     ("BATCH_SIZE: 64", "BATCH_SIZE: 2")):
        assert old in text
        text = text.replace(old, new)
    text += ("N_BANDS: 16\nTIMESTEPS: 3\nLATENT_DIM: 16\nSYNTH_ON_DEVICE: true\n"
             "SYNTH_STEPS_PER_EPOCH: 1\nSYNTH_EVAL_SAMPLES: 2\n")
    cfg = tmp_path / "c.yaml"
    cfg.write_text(text)
    train_biear.main(["--config", str(cfg), "--epochs", "1", "--quiet",
                      "--device", "cpu"])
    (run,) = os.listdir(tmp_path / "runs")
    with open(tmp_path / "runs" / run / "logs_json" / "history.json") as f:
        assert len(json.load(f)["train"]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_biear.main(["--config", str(cfg), "--epochs", "1"])
