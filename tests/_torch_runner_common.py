"""Shared pieces of the runner parity tests (tests/test_torch_port_runner.py,
tests/test_torch_port_config.py, tests/test_torch_port_passive.py and
tests/test_torch_port_auralnet.py): the
seeded in-memory dataset, the passive ``.shard`` splits, the small run
configs of both packages, one JAX ``train`` run per optimizer shape (the
passive model's single group is one) with its initial state and epoch-1
checkpoint captured, and the port runs resumed from a JAX state. The
AuralNet shape is the global-clip single group of its own model.

One JAX run compiles a train and an eval step (~20 s on the CPU), so each
optimizer shape runs once per module and the shapes are split between the
two files, which pytest-xdist gives to different workers.
"""

import contextlib
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biear_tpu.config import load_run_config as jax_run_config
from biear_tpu.models.config import BiEARConfig as JaxConfig
from biear_tpu.train import runner as jrun
from biear_tpu.train import state as jstate
from biear_tpu.utils import qvis as jqvis

from biear_tpu_torch import config as tcfg
from biear_tpu_torch.data.shard import write_shard
from biear_tpu_torch.models import (ActiveBiEAR, AuralNet, BiEARConfig,
                                    PassiveBiEAR)
from biear_tpu_torch.models.weights import state_dict_from_jax
from biear_tpu_torch.train import optim as topt
from biear_tpu_torch.train import runner as trun
from biear_tpu_torch.train import state as tstate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf", "config.yaml")
CONF_PASSIVE = os.path.join(REPO, "conf", "config_passive.yaml")
CONF_AURALNET = os.path.join(REPO, "conf", "config_auralnet_deepear.yaml")
SMALL = dict(fs=1600, timesteps=3, n_fft=256, n_bands=16, fmin=50.0,
             fmax=700.0, latent_dim=16, ctrl_hidden=16, deltaQ_mode="relative",
             ctrl_dropout=0.0, backend_dropout=0.0)
# the limits of the 3-step trajectory test (tests/test_torch_port_train.py)
LOSS_TOL, PARAM_TOL = 5e-5, 3e-3
ROWS, BATCH, SEED = 12, 4, 0
SHAPES = {"two-group": {}, "fixed-q": {"fixed_frontend_q": True},
          "frozen": {"freeze_q_controller_only": True}, "passive": {},
          "auralnet": {"fixed_frontend_q": True}}
# AuralNet at SMALL's geometry: 2 layers of width 32, 4 heads, dropout 0
SMALL_ATTN = dict(d_model=32, attn_heads=4, attn_layers=2, attn_dropout=0.0)
CONFS = {"passive": CONF_PASSIVE, "auralnet": CONF_AURALNET}
MODELS = {"passive": PassiveBiEAR, "auralnet": AuralNet}


class Mem:
    """An in-memory dataset with rows() / len()."""

    def __init__(self, arrays):
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays[0])

    def rows(self, idx):
        return tuple(a[np.asarray(idx)] for a in self.arrays)


def dataset(seed=11):
    """ROWS rows of uniform waveforms and CC, structurally valid labels."""
    rng = np.random.default_rng(seed)
    y = np.zeros((ROWS, 8, 7), np.float32)
    y[:, :, 2] = 1.0
    for b in range(ROWS):
        for s in rng.choice(8, size=rng.integers(1, 4), replace=False):
            y[b, s, :2] = (1.0, rng.uniform())
            y[b, s, 2:] = 0.0
            y[b, s, 2 + rng.integers(1, 5)] = 1.0
    fs, nb = SMALL["fs"], SMALL["n_bands"]
    return Mem([rng.uniform(-1, 1, (ROWS, fs)).astype(np.float32),
                rng.uniform(-1, 1, (ROWS, fs)).astype(np.float32),
                rng.uniform(-1, 1, (ROWS, nb)).astype(np.float32),
                y.reshape(ROWS, 56)])


def splits():
    ds = dataset()
    return {"train": ds, "val": ds, "test": ds}


def passive_dataset(seed=12):
    """ROWS rows of the passive fields at SMALL's geometry: magnitude
    planes in dB, phase planes in (-pi, pi), the CC feature, labels."""
    rng = np.random.default_rng(seed)
    tb = (ROWS, SMALL["timesteps"], SMALL["n_bands"])
    y = dataset(seed).arrays[3]
    return Mem([rng.uniform(-80, 0, tb).astype(np.float32),
                rng.uniform(-80, 0, tb).astype(np.float32),
                rng.uniform(-1, 1, tb[::2]).astype(np.float32),
                rng.uniform(-np.pi, np.pi, tb).astype(np.float32),
                rng.uniform(-np.pi, np.pi, tb).astype(np.float32), y])


def write_passive_shards(root):
    """passive_dataset() as the train, val and test ``.shard`` splits under
    the names ``data_paths`` gives a passive run."""
    os.makedirs(root, exist_ok=True)
    arrays = passive_dataset().arrays
    for split in ("train", "val", "test2"):
        write_shard(os.path.join(root, f"anechoic_{split}_gt_group_phase"
                                       ".shard"), arrays)
    return str(root)


def run_config(jax_side: bool, runs_root, shape: str, shard_root=None):
    """conf/config.yaml (conf/config_passive.yaml for the passive shape,
    on the .shard splits under shard_root; conf/config_auralnet_deepear.yaml
    for AuralNet) at SMALL's geometry, 2 epochs of batch BATCH, in one
    optimizer shape, for either package."""
    load, cfg_cls = ((jax_run_config, JaxConfig) if jax_side
                     else (tcfg.load_run_config, BiEARConfig))
    rc = load(CONFS.get(shape, CONF))
    if shape == "passive":
        rc.data_format, rc.shard_root = "shard", str(shard_root)
    rc.runs_root, rc.epochs, rc.batch_size = str(runs_root), 2, BATCH
    rc.print_every = 1000
    over = SHAPES[shape]
    rc.fixed_frontend_q = over.get("fixed_frontend_q", False)
    rc.freeze_q_controller_only = over.get("freeze_q_controller_only", False)
    attn = SMALL_ATTN if shape == "auralnet" else {}
    rc.model_cfg = cfg_cls(**SMALL, **attn,
                           fixed_frontend_q=rc.fixed_frontend_q)
    return rc


@contextlib.contextmanager
def small_cpu():
    """One torch thread (tiny CPU ops run far slower across many threads),
    no TensorBoard (its import can pull in TensorFlow) and no JAX Q plots,
    for a module's runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    mp.setattr(jqvis, "visualize_Q_LR", lambda *a, **k: None)
    try:
        yield
    finally:
        mp.undo()
        torch.set_num_threads(threads)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_run(shape: str, root) -> dict:
    """JAX train for 2 epochs in `shape`: its initial (params, opt_state)
    as numpy, a copy of its 'last' checkpoint after epoch 1, its run
    directory, history and run config (the passive shape on its .shard
    splits, whose directory it records)."""
    shard_root = (write_passive_shards(root / "passive-shards")
                  if shape == "passive" else None)
    rc = run_config(True, root / shape, shape, shard_root)
    seen = {"rc": rc, "shard_root": shard_root}
    shard_opt, save = jrun.shard_opt_state, jstate.save_checkpoint

    def capture_init(opt_state, params, mesh):
        seen.setdefault("init", (to_np(params), to_np(opt_state)))
        return shard_opt(opt_state, params, mesh)

    def keep_epoch1(path, params, opt_state=None, meta=None):
        save(path, params, opt_state, meta)
        if os.path.basename(path) == "last" and meta["epoch"] == 1:
            seen["last1"] = str(root / f"{shape}-last1")
            shutil.copytree(path, seen["last1"])

    mp = pytest.MonkeyPatch()
    mp.setattr(jrun, "shard_opt_state", capture_init)
    mp.setattr(jstate, "save_checkpoint", keep_epoch1)
    try:
        with jax.default_matmul_precision("highest"):
            res = jrun.train(rc, datasets=None if shard_root else splits(),
                             quiet=True, run_id="J", seed=SEED)
    finally:
        mp.undo()
    seen.update(run_dir=res["run_dir"], history=res["history"])
    return seen


def restore_jax(run, path):
    """A JAX runner checkpoint as numpy (params, opt_state, meta); the
    run's captured initial state is the restore template."""
    like = jax.tree.map(jnp.asarray, run["init"])
    p, o, meta = jstate.load_checkpoint(path, *like)
    return to_np(p), to_np(o), meta


def port_run_from(tmp_path, params_np, opt_np, meta, cfg, history=None):
    """A port run directory whose checkpoints/last holds a JAX state."""
    run = tmp_path / "port"
    last = run / "checkpoints" / "last"
    last.mkdir(parents=True)
    torch.save(state_dict_from_jax(params_np, cfg), last / "params.pth")
    torch.save(tstate.adam_state_from_optax(opt_np, cfg),
               last / "opt_state.pt")
    (last / "meta.json").write_text(json.dumps(meta))
    if history is not None:
        (run / "logs_json").mkdir()
        (run / "logs_json" / "history.json").write_text(json.dumps(history))
    return str(run)


def port_train(rc, resume_from):
    """The port's train from resume_from, on the in-memory splits or on
    the run config's .shard splits."""
    return trun.train(rc, datasets=(None if rc.data_format == "shard"
                                    else splits()),
                      quiet=True, seed=SEED, resume_from=resume_from,
                      device="cpu")


def assert_losses(got, want, epochs):
    for split in ("train", "val"):
        for e in epochs:
            g, w = got[split][e]["loss"], want[split][e]["loss"]
            assert abs(g - w) < LOSS_TOL, (split, e, g, w)
            assert got[split][e]["skipped"] == want[split][e]["skipped"] == 0


def assert_params(model, params_np):
    want = state_dict_from_jax(params_np, model.cfg)
    got = model.state_dict()
    diffs = {k: float((got[k] - want[k]).abs().max()) for k in want}
    assert max(diffs.values()) < PARAM_TOL, sorted(
        diffs.items(), key=lambda kv: -kv[1])[:5]


def check_adam_conversion(shape, run):
    """JAX's initial optax state, converted: the port optimizer's group
    labels, names, shapes and int32 zero counts, and it loads."""
    rc = run_config(False, "unused", shape, run["shard_root"])
    conv = tstate.adam_state_from_optax(run["init"][1], rc.model_cfg)
    model = MODELS.get(shape, ActiveBiEAR)(rc.model_cfg)
    opt = topt.make_optimizer(model, rc.hyper, freeze_controller=(
        rc.freeze_q_controller_only and not rc.fixed_frontend_q))
    own = opt.state_dict()
    assert conv.keys() == own.keys(), shape
    for label in own:
        assert int(conv[label]["count"]) == 0
        assert conv[label]["count"].dtype == torch.int32
        for key in ("m", "v"):
            assert set(conv[label][key]) == set(own[label][key])
            for n, t in own[label][key].items():
                assert conv[label][key][n].shape == t.shape
    opt.load_state_dict(conv)


def check_port_resume(shape, run, tmp_path):
    """JAX's epoch-1 'last' (non-zero moments, counts 3), turned into a
    port checkpoint, trains epoch 2 as JAX does."""
    rc = run_config(False, tmp_path, shape, run["shard_root"])
    p1, o1, meta1 = restore_jax(run, run["last1"])
    assert meta1["epoch"] == 1 and meta1["global_step"] == 3
    conv = tstate.adam_state_from_optax(o1, rc.model_cfg)
    assert all(int(g["count"]) == 3 for g in conv.values())
    assert sum(float(t.abs().sum()) for g in conv.values()
               for t in g["m"].values()) > 0
    history1 = {k: v[:1] for k, v in run["history"].items()}
    out = port_train(rc, port_run_from(tmp_path, p1, o1, meta1, rc.model_cfg,
                                       history1))
    assert len(out["history"]["train"]) == 2
    assert_losses(out["history"], run["history"], (1,))
    p2, _, _ = restore_jax(run, os.path.join(run["run_dir"], "checkpoints",
                                             "last"))
    assert_params(out["model"], p2)
    assert out["global_step"] == 6
    for g in out["optimizer"].groups:
        assert g.frozen == (shape == "frozen" and g.label == "frozen")
        assert g.frozen or int(g.count) == 6
