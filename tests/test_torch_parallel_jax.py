"""The port's DP+TP train step on a 2x2 mesh of gloo ranks held against the
JAX package's train step on its own 2x2 mesh (CPU).

JAX runs ``make_train_step`` on ``make_mesh(2, 2)`` (four of the eight
virtual CPU devices tests/conftest.py gives the process), its parameters
and optimizer state placed by ``shard_params`` / ``shard_opt_state`` and
the batch sharded over 'data'. The port runs four gloo ranks
(tests/_torch_parallel_worker.py) on a 2x2 mesh. Both start from the same
weights (``state_dict_from_jax``) and take 3 steps on the same global
batches of 8 rows, with padded tails (weights 0; the third batch's second
half, so one data rank holds only padding), dropout 0, f32 at full
precision. Limits: the loss per step to rtol 2e-4 (tests/test_sharding.py's
mesh-vs-single-device tolerance), the parameters to 3e-3 (the port's
3-step trajectory limit against JAX, tests/test_torch_port_train.py), the
parameters' change over the 3 steps to 1e-2 of the largest change
(reading 7.4e-5) and the gradient norms at every step to rtol 1e-4
(readings up to 3.6e-7), as tests/test_torch_parallel_steps.py says why.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biear_tpu.models.biear import init_active
from biear_tpu.models.config import BiEARConfig as JaxConfig
from biear_tpu.parallel.mesh import (batch_sharding, make_mesh, shard_opt_state,
                                     shard_params)
from biear_tpu.train import TrainHyper as JaxHyper
from biear_tpu.train import make_optimizer as jax_optimizer
from biear_tpu.train import make_train_step as jax_train_step

from _torch_parallel_worker import launch
from test_torch_parallel_steps import (NORM_RTOL, SMALL, STEPS, UPDATE_TOL,
                                       _batches, update_distance)

from biear_tpu_torch.models import BiEARConfig
from biear_tpu_torch.models.weights import state_dict_from_jax

LOSS_RTOL, PARAM_TOL = 2e-4, 3e-3


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    if len(jax.devices()) < 4:
        pytest.fail("tests/conftest.py gives JAX 8 CPU devices; found "
                    f"{len(jax.devices())}")
    tmp = tmp_path_factory.mktemp("parallel-jax")
    cfg_j = JaxConfig(**SMALL)
    params = init_active(jax.random.PRNGKey(0), cfg_j)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params),
                             BiEARConfig(**SMALL))
    torch.save(sd, tmp / "w.pt")
    batches = _batches("active", seed=5)
    np.savez(tmp / "b.npz", n=len(batches[0]),
             **{f"b{i}_{j}": a for i, b in enumerate(batches)
                for j, a in enumerate(b)})
    launch(4, "steps", {"out": str(tmp), "cases": [dict(
        name="port", family="active", cfg=SMALL, mesh=[2, 2],
        weights=str(tmp / "w.pt"), batches=str(tmp / "b.npz"),
        steps=STEPS)]})

    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    hp = JaxHyper()
    with jax.default_matmul_precision("highest"):
        p = shard_params(params, mesh)
        opt = jax_optimizer(p, hp)
        state = shard_opt_state(opt.init(p), p, mesh)
        step = jax_train_step(cfg_j, hp, opt, "active")
        losses, norms = [], []
        for b in batches:
            b = tuple(jax.device_put(a, batch_sharding(mesh)) for a in b)
            p, state, m = step(p, state, b, jax.random.PRNGKey(7),
                               jnp.float32(1.0))
            losses.append(float(m["loss"]))
            norms.append([float(m["grad_fb_norm"]),
                          float(m["grad_backend_norm"])])
            assert float(m["skipped"]) == 0.0
    ranks = [json.loads((tmp / f"port.rank{r}.json").read_text())
             for r in range(4)]
    return {"jax_losses": losses, "jax_norms": norms, "init": sd,
            "jax_params": state_dict_from_jax(
                jax.tree.map(np.asarray, p), BiEARConfig(**SMALL)),
            "ranks": ranks,
            "port_params": torch.load(tmp / "port.pt", weights_only=True)}


def test_losses_match_jax_on_its_mesh(trajectories):
    want = trajectories["jax_losses"]
    for r in trajectories["ranks"]:
        assert r["skipped"] == [0.0] * STEPS
        np.testing.assert_allclose(r["losses"], want, rtol=LOSS_RTOL)


def test_parameters_match_jax_on_its_mesh(trajectories):
    want, got = trajectories["jax_params"], trajectories["port_params"]
    assert set(got) == set(want)
    diffs = {k: float((got[k] - v).abs().max()) for k, v in want.items()}
    assert max(diffs.values()) < PARAM_TOL, sorted(
        diffs.items(), key=lambda kv: -kv[1])[:5]
    # the whole update, the last step's (one data rank all padding) too
    assert update_distance(got, want, trajectories["init"]) < UPDATE_TOL
    # the controllers trained: their zero-initialised output layer moved
    assert float(got["bifb.fb_L.q_out.8.weight"].abs().max()) > 0



def test_gradient_norms_match_jax_on_its_mesh(trajectories):
    for r in trajectories["ranks"]:
        np.testing.assert_allclose(r["norms"], trajectories["jax_norms"],
                                   rtol=NORM_RTOL)
