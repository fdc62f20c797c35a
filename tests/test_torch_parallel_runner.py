"""The port's runner (``train.runner.train``) across gloo ranks (CPU
processes, tests/_torch_parallel_worker.py): the counterpart of
tests/test_multihost.py's two-process runner.

  * two ranks (2x1) train two tiny epochs from ``.shard`` splits and from
    the synthesised path; both ranks report the same history, exactly one
    run tree exists and rank 1 writes nothing under the runs root (a
    tripwire fails any write); the histories equal a world-of-one run's
    (loss rtol 2e-4, tests/test_sharding.py's tolerance): each global
    batch holds the same rows at every world size, dropout is 0;
  * the two-rank run's best.pth loads strictly into a one-device model,
    and its ``last`` resumes in a world of one;
  * a world-of-one ``last`` resumes on a 2x2 mesh (the runner under
    tensor parallelism) and trains its next epoch as the world of one
    does.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from _torch_parallel_worker import launch, run_config

from biear_tpu_torch import config as tcfg
from biear_tpu_torch import train_biear
from biear_tpu_torch.data.shard import write_shard
from biear_tpu_torch.models import ActiveBiEAR
from biear_tpu_torch.train import runner as trun
from biear_tpu_torch.train import state as tstate
from biear_tpu_torch.train.optim import make_optimizer

SMALL = dict(fs=1600, timesteps=3, n_fft=256, n_bands=16, fmin=50.0,
             fmax=700.0, latent_dim=16, ctrl_hidden=16,
             deltaQ_mode="relative", ctrl_dropout=0.0, backend_dropout=0.0)
SYNTH = dict(n_bands=16, timesteps=3, latent_dim=16, ctrl_hidden=16,
             deltaQ_mode="relative", ctrl_dropout=0.0, backend_dropout=0.0)
ROWS, LOSS_RTOL = 12, 2e-4


def _spec(kind: str, runs_root, shard_root=None, **fields) -> dict:
    base = dict(runs_root=str(runs_root), epochs=2, print_every=1000,
                hist_every=1)
    if kind == "shard":
        base.update(batch_size=4, data_format="shard",
                    shard_root=str(shard_root))
        return {"conf": "config.yaml", "cfg": SMALL,
                "fields": dict(base, **fields)}
    base.update(batch_size=2, synth_on_device=True)
    return {"conf": "config.yaml", "cfg": SYNTH,
            "fields": dict(base, **fields),
            "raw": {"SYNTH_STEPS_PER_EPOCH": 3, "SYNTH_CHUNK_STEPS": 2,
                    "SYNTH_EVAL_SAMPLES": 5}}


def _write_shards(root, rc):
    """ROWS seeded rows as the train, val and test splits of `rc`."""
    rng = np.random.default_rng(11)
    y = np.zeros((ROWS, 8, 7), np.float32)
    y[:, :, 2] = 1.0
    for b in range(ROWS):
        s = rng.integers(0, 8)
        y[b, s, :2] = (1.0, rng.uniform())
        y[b, s, 2:] = 0.0
        y[b, s, 2 + rng.integers(1, 5)] = 1.0
    fs, nb = SMALL["fs"], SMALL["n_bands"]
    arrays = [rng.uniform(-1, 1, (ROWS, fs)).astype(np.float32),
              rng.uniform(-1, 1, (ROWS, fs)).astype(np.float32),
              rng.uniform(-1, 1, (ROWS, nb)).astype(np.float32),
              y.reshape(ROWS, 56)]
    os.makedirs(root, exist_ok=True)
    for path in tcfg.data_paths(rc).values():
        write_shard(path, arrays)


def _results(outs) -> list:
    return [json.loads(next(line[7:] for line in o.splitlines()
                            if line.startswith("RESULT ")))
            for o in outs]


def _train_here(spec, **kw):
    """The world-of-one run of a spec, in this process."""
    rc = run_config(spec)
    synth = train_biear.make_synth(rc, "cpu") if rc.synth_on_device else None
    return trun.train(rc, synth=synth, quiet=True, seed=0, device="cpu",
                      **kw)


def _strip(h):
    return [{k: v for k, v in e.items() if k != "sec"} for e in h]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel-runner")
    shards = tmp / "shards"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    try:
        _write_shards(shards, run_config(_spec("shard", tmp, shards)))
        out = {}
        for kind in ("shard", "synth"):
            spec = _spec(kind, tmp / f"{kind}-2", shards)
            out[kind] = {"ranks": _results(launch(2, "runner", spec)),
                         "root": tmp / f"{kind}-2"}
            # the world of one: one epoch, then a resume for the second
            one = _train_here(_spec(kind, tmp / f"{kind}-1", shards,
                                    epochs=1), run_id="one")
            if kind == "shard":
                out["last1"] = tmp / "shard-last1"
                shutil.copytree(one["run_dir"], out["last1"])
            out[kind]["one"] = _train_here(
                _spec(kind, tmp / f"{kind}-1", shards),
                resume_from=one["run_dir"])
        # a world-of-one 'last' of epoch 1 resumed on 2x2 for epoch 2
        spec = _spec("shard", tmp, shards, mesh_model=2)
        spec["resume_from"] = str(out["last1"])
        out["2x2"] = _results(launch(4, "runner", spec))
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    out["tmp"] = tmp
    return out


@pytest.mark.parametrize("kind", ["shard", "synth"])
def test_two_ranks_write_one_run_tree(runs, kind):
    a, b = runs[kind]["ranks"]
    assert a == b                      # the same history on both ranks
    trees = os.listdir(runs[kind]["root"])
    assert len(trees) == 1 and a["run_dir"] == str(runs[kind]["root"] /
                                                   trees[0])
    for rel in ("meta/settings.json", "logs_json/history.json",
                "logs_json/test_metrics.json", "logs_json/scalars.jsonl",
                "checkpoints/best/params.pth", "checkpoints/last/params.pth",
                "checkpoints/last/opt_state.pt"):
        assert os.path.isfile(os.path.join(a["run_dir"], rel)), rel
    steps = [json.loads(s)["step"] for s in open(os.path.join(
        a["run_dir"], "logs_json", "scalars.jsonl")) if "train_step/loss" in s]
    assert steps == list(range(a["global_step"]))


@pytest.mark.parametrize("kind", ["shard", "synth"])
def test_two_rank_history_matches_the_world_of_one(runs, kind):
    got, one = runs[kind]["ranks"][0], runs[kind]["one"]
    assert got["global_step"] == one["global_step"]
    for split in ("train", "val"):
        want = _strip(one["history"][split])
        assert len(got[split]) == len(want) == 2
        for g, w in zip(got[split], want):
            assert g["skipped"] == w["skipped"] == 0
            for k in ("loss", "sound_acc", "aoa_mae", "dist_acc"):
                np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                           err_msg=f"{split} {k}")
    np.testing.assert_allclose(got["test"][0]["loss"], one["test"]["loss"],
                               rtol=LOSS_RTOL)


def test_best_loads_strictly_into_a_one_device_model(runs):
    run = runs["shard"]["ranks"][0]["run_dir"]
    rc = run_config(_spec("shard", runs["tmp"], runs["tmp"] / "shards"))
    model = ActiveBiEAR(rc.model_cfg)
    sd = torch.load(os.path.join(run, "checkpoints", "best", "params.pth"),
                    weights_only=True)
    model.load_state_dict(sd, strict=True)
    assert list(sd) == list(model.state_dict())
    tstate.load_checkpoint(os.path.join(run, "checkpoints", "last"), model,
                           make_optimizer(model, rc.hyper))


def test_two_rank_last_resumes_in_a_world_of_one(runs):
    got = runs["shard"]["ranks"][0]
    spec = _spec("shard", runs["tmp"], runs["tmp"] / "shards", epochs=3)
    out = _train_here(spec, resume_from=got["run_dir"])
    assert len(out["history"]["train"]) == 3
    assert _strip(out["history"]["train"][:2]) == got["train"]
    assert out["global_step"] == 9 and np.isfinite(
        out["history"]["train"][2]["loss"])


def test_world_of_one_last_resumes_on_2x2(runs):
    ranks, one = runs["2x2"], runs["shard"]["one"]
    assert all(r == ranks[0] for r in ranks)
    got = ranks[0]
    assert got["global_step"] == one["global_step"] == 6
    for split in ("train", "val"):
        want = _strip(one["history"][split])
        assert got[split][0] == want[0]        # epoch 1, read back
        np.testing.assert_allclose(got[split][1]["loss"], want[1]["loss"],
                                   rtol=LOSS_RTOL)
