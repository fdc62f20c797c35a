"""The port's train step over a data x model mesh held against its own
world-of-one step, on gloo ranks (CPU processes, tests/_torch_parallel_worker.py).

The same weights take 3 steps on the same global batches of 8 rows: one
whole, one with a padded tail, one whose second half is padding (so on
two data ranks rank 1 holds only weight-0 rows). DP 2x1, TP 1x2 and DP+TP
2x2 must give, for the active (dual controller), passive and AuralNet
models, dropout 0, with every rank reporting the same losses:

  * the world-of-one losses to rtol 2e-4 (the DP / DP+TP tolerance of
    tests/test_sharding.py) and its parameters to 3e-3 (the port's 3-step
    trajectory limit, tests/test_torch_port_train.py);
  * its whole update, the parameters' change over the 3 steps, to 1e-2 of
    the largest change (Adam moves each element by ~1e-4 a step, ~3e-4 in
    all, so the 3e-3 limit alone would not see the last step; readings
    4.96e-5, one rounding of the parameters; a dropped step is ~0.3);
  * its gradient norms at every step to rtol 1e-4 (readings up to 2.1e-7):
    Adam's update and the clip below its norm do not see a gradient
    scaled by a constant, the norms do.

Also: an infinite gradient on one rank skips the step on every rank (a
replicated tensor under DP, a cut one under DP+TP); the histograms are
the whole tensors'; dropout masks differ across data ranks and are equal
across the model ranks of a replicated activation.
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_parallel_worker import launch

from biear_tpu_torch.models import (ActiveBiEAR, AuralNet, BiEARConfig,
                                    PassiveBiEAR)
from biear_tpu_torch.train.loop import make_train_step
from biear_tpu_torch.train.optim import TrainHyper, make_optimizer

SMALL = dict(fs=1600, timesteps=3, n_fft=256, n_bands=16, fmin=50.0,
             fmax=700.0, latent_dim=16, ctrl_hidden=16, deltaQ_mode="relative",
             ctrl_dropout=0.0, backend_dropout=0.0)
ATTN = dict(d_model=32, attn_heads=4, attn_layers=2, attn_dropout=0.0,
            fixed_frontend_q=True)
# "active-bf16": the production policy, whose dual frontend trains
# through the recurrence Function (models/frontend_bwd.py)
FAMILIES = {"active": (ActiveBiEAR, SMALL), "passive": (PassiveBiEAR, SMALL),
            "auralnet": (AuralNet, dict(SMALL, **ATTN)),
            "active-bf16": (ActiveBiEAR, dict(SMALL,
                                              fb_w_dtype="bfloat16"))}
B, STEPS = 8, 3
LOSS_RTOL, PARAM_TOL, UPDATE_TOL, NORM_RTOL = 2e-4, 3e-3, 1e-2, 1e-4
WEIGHTS = (np.ones(B), np.r_[np.ones(6), np.zeros(2)],
           np.r_[np.ones(4), np.zeros(4)])
MESHES = {2: ([2, 1], [1, 2]), 4: ([2, 2],)}


def _targets(rng):
    y = np.zeros((B, 8, 7), np.float32)
    y[:, :, 2] = 1.0
    for b in range(B):
        for s in rng.choice(8, size=rng.integers(1, 4), replace=False):
            y[b, s, :2] = (1.0, rng.uniform())
            y[b, s, 2:] = 0.0
            y[b, s, 2 + rng.integers(1, 5)] = 1.0
    return y.reshape(B, 56)


def _batches(family, seed=0):
    """STEPS global batches of B rows as lists of float32 arrays, each
    with its weights last."""
    rng = np.random.default_rng(seed)
    out = []
    for w in WEIGHTS:
        u = lambda *shape: rng.uniform(-1, 1, shape).astype(np.float32)
        if family == "passive":
            tb = (B, SMALL["timesteps"], SMALL["n_bands"])
            arrays = [rng.uniform(-80, 0, tb), rng.uniform(-80, 0, tb),
                      u(B, 16), rng.uniform(-np.pi, np.pi, tb),
                      rng.uniform(-np.pi, np.pi, tb)]
        else:
            arrays = [u(B, SMALL["fs"]), u(B, SMALL["fs"]), u(B, 16)]
        out.append([np.asarray(a, np.float32) for a in arrays]
                   + [_targets(rng), w.astype(np.float32)])
    return out


def _world_of_one(model, batches):
    hp = TrainHyper()
    step = make_train_step(model, hp, make_optimizer(model, hp))
    ms = [step(tuple(torch.as_tensor(a) for a in b), torch.Generator())
          for b in batches]
    return ([float(m["loss"]) for m in ms],
            [[float(m["grad_fb_norm"]), float(m["grad_backend_norm"])]
             for m in ms], ms[-1])


def update_distance(got: dict, want: dict, init: dict) -> float:
    """max |(got - init) - (want - init)| over max |want - init| over every
    tensor: how far the trajectory's whole update is from the reference's,
    relative to the distance the parameters moved."""
    moved = max(float((want[k] - v).abs().max()) for k, v in init.items())
    return max(float(((got[k] - v) - (want[k] - v)).abs().max())
               for k, v in init.items()) / moved


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel-steps")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ref, cases = {}, {2: [], 4: []}
    try:
        for family, (cls, kw) in FAMILIES.items():
            model = cls(BiEARConfig(**kw)).init_weights_(0)
            torch.save(model.state_dict(), tmp / f"{family}.pt")
            batches = _batches(family)
            np.savez(tmp / f"{family}.npz", n=len(batches[0]),
                     **{f"b{i}_{j}": a for i, b in enumerate(batches)
                        for j, a in enumerate(b)})
            init = {k: v.clone() for k, v in model.state_dict().items()}
            losses, norms, last = _world_of_one(model, batches)
            ref[family] = {"losses": losses, "params": model.state_dict(),
                           "init": init, "norms": norms, "last": last}
            for n, meshes in MESHES.items():
                for mesh in meshes:
                    if mesh == [1, 2] and not family.startswith("active"):
                        continue
                    cases[n].append(dict(
                        name=f"{family}-{mesh[0]}x{mesh[1]}", family=family,
                        cfg=kw, mesh=mesh, weights=str(tmp / f"{family}.pt"),
                        batches=str(tmp / f"{family}.npz"), steps=STEPS))
    finally:
        torch.set_num_threads(threads)
    poison = {2: ("encoder_ild.gru1.weight_ih_l0", 1, [2, 1]),
              4: ("body.0.weight", 3, [2, 2])}
    for n, (param, rank, mesh) in poison.items():
        cases[n].append(dict(cases[n][0], name=f"poison-{n}", mesh=mesh,
                             poison=dict(rank=rank, step=1, param=param)))
    for n in cases:
        launch(n, "steps", {"cases": cases[n], "out": str(tmp)})

    def read(name, n):
        ranks = [json.loads((tmp / f"{name}.rank{r}.json").read_text())
                 for r in range(n)]
        full = (torch.load(tmp / f"{name}.pt", weights_only=True)
                if (tmp / f"{name}.pt").exists() else None)
        return ranks, full
    return {"ref": ref, "read": read, "tmp": tmp}


CASES = [("active", "2x1", 2), ("passive", "2x1", 2), ("auralnet", "2x1", 2),
         ("active", "1x2", 2), ("active", "2x2", 4), ("passive", "2x2", 4),
         ("auralnet", "2x2", 4), ("active-bf16", "2x1", 2),
         ("active-bf16", "1x2", 2), ("active-bf16", "2x2", 4)]


@pytest.mark.parametrize("family,mesh,n", CASES,
                         ids=[f"{f}-{m}" for f, m, _ in CASES])
def test_mesh_step_matches_the_world_of_one(runs, family, mesh, n):
    ranks, full = runs["read"](f"{family}-{mesh}", n)
    ref = runs["ref"][family]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]        # every rank agrees
        assert r["skipped"] == [0.0] * STEPS
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"],
                               rtol=LOSS_RTOL)
    assert list(full) == list(ref["params"])           # names and order
    diffs = {k: float((full[k] - v).abs().max())
             for k, v in ref["params"].items()}
    assert max(diffs.values()) < PARAM_TOL, sorted(
        diffs.items(), key=lambda kv: -kv[1])[:5]
    # every step's update, the last one's (where a data rank holds only
    # padding) included: the parameters moved ~3e-4 in all
    assert update_distance(full, ref["params"], ref["init"]) < UPDATE_TOL


@pytest.mark.parametrize("n", [2, 4], ids=["dp-replicated", "dp-tp-cut"])
def test_nonfinite_gradient_on_one_rank_skips_on_every_rank(runs, n):
    ranks, _ = runs["read"](f"poison-{n}", n)
    for r in ranks:
        assert r["skipped"] == [0.0, 1.0, 0.0]
        assert r["losses"] == ranks[0]["losses"]
        assert all(np.isfinite(r["losses"]))


def test_norms_and_histograms_are_the_whole_tensors(runs):
    """Every step's gradient norms and the last step's histograms, for
    every family and mesh."""
    for family, mesh, n in CASES:
        ref = runs["ref"][family]
        ranks, _ = runs["read"](f"{family}-{mesh}", n)
        want = ref["last"]["grad_hist"].numpy()
        for r in ranks:
            np.testing.assert_allclose(r["norms"], ref["norms"],
                                       rtol=NORM_RTOL)
            got = np.asarray(r["grad_hist"])
            assert got.shape == want.shape, (family, mesh)
            np.testing.assert_array_equal(got.sum(1), want.sum(1))
            assert np.abs(got - want).max() <= 1e-3 * want.sum(1).max()


def test_dropout_masks_differ_over_data_and_agree_over_model(runs):
    tmp = runs["tmp"]
    kw = dict(SMALL, backend_dropout=0.5)
    torch.save(ActiveBiEAR(BiEARConfig(**kw)).init_weights_(0).state_dict(),
               tmp / "drop.pt")
    np.save(tmp / "x.npy", np.random.default_rng(2).uniform(
        0.5, 1.5, (4, 48)).astype(np.float32))
    (tmp / "drop").mkdir()
    launch(4, "dropout", {"cfg": kw, "mesh": [2, 2],
                          "weights": str(tmp / "drop.pt"),
                          "x": str(tmp / "x.npy"), "out": str(tmp / "drop")})
    o = [torch.load(tmp / "drop" / f"rank{r}.pt", weights_only=True)
         for r in range(4)]
    # ranks (0, 1) are data rank 0, ranks (2, 3) data rank 1
    for k in ("body", "sound", "aoa", "dist"):
        assert torch.equal(o[0][k], o[1][k]) and torch.equal(o[2][k],
                                                             o[3][k]), k
        assert not torch.equal(o[0][k], o[2][k]), k
    # the shared stream stays in step on every rank
    assert all(torch.equal(o[0]["shared_state"], x["shared_state"])
               for x in o)
    # masks were drawn: some body units dropped, the others scaled
    assert (o[0]["body"] == 0).any() and (o[0]["body"] > 0).any()
