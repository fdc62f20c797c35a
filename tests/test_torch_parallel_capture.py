"""The captured mesh programs, checked on the CPU with two gloo ranks.

On the card under a mesh without a model axis, ``make_train_step`` and
``make_train_chunk`` capture each step as two CUDA graphs around the eager
flat all-reduce of the gradients (``train/graph.py::CapturedMeshStep``,
``CapturedMeshChunk``), and the eval step and chunk capture whole. This
machine has no card, so the ranks (tests/_torch_parallel_worker.py, task
``capture``) run the capture logic with the CPU stand-ins of
tests/_torch_graph_stand_in.py, the model taken to be on a card so that
each entry point takes its path by the real rule (``graph.use_capture``).
Checked:

  * under a 2x1 mesh, dropout on, the two-graph chunk and step equal the
    eager mesh chunk and step bit for bit, in metrics, parameters and
    generator state, over two chunks of re-seeded generators and one step
    at lr_scale 0.5; the captured eval step and chunk equal the eager ones;
  * ``pack_grads`` -> the all-reduce -> ``unpack_grads`` equals the
    one-call reduction it replaced bit for bit, a rank of weight 0 too;
  * re-seeded persistent dropout streams draw what fresh
    ``keyed_generator``s drew;
  * a warm send half and receive half make no host sync and build no host
    constant (tests/test_torch_port_capture.py's watch);
  * under a 1x2 mesh ``capture=True`` raises for every entry point and the
    default is eager;
  * the captured 2x1 step matches JAX ``make_train_step`` on its own
    ``make_mesh(2, 1)`` at the limits of tests/test_torch_parallel_jax.py
    (loss rtol 2e-4, parameters 3e-3, the whole update 1e-2, gradient
    norms rtol 1e-4).

The card's own check is tests/test_torch_port_capture_card.py (a world of
one over NCCL) and ``chip_smoke.py`` phase 16.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biear_tpu.models.biear import init_active
from biear_tpu.models.config import BiEARConfig as JaxConfig
from biear_tpu.parallel.mesh import (batch_sharding, make_mesh,
                                     shard_opt_state, shard_params)
from biear_tpu.train import TrainHyper as JaxHyper
from biear_tpu.train import make_optimizer as jax_optimizer
from biear_tpu.train import make_train_step as jax_train_step

from _torch_parallel_worker import launch
from test_torch_parallel_jax import LOSS_RTOL, PARAM_TOL
from test_torch_parallel_steps import (NORM_RTOL, SMALL, STEPS, UPDATE_TOL,
                                       _batches, update_distance)
from test_torch_port_capture import _family, watching_host

from biear_tpu_torch import graph as cgraph
from biear_tpu_torch.models import ActiveBiEAR, BiEARConfig
from biear_tpu_torch.models.layers import RankGenerators
from biear_tpu_torch.models.weights import state_dict_from_jax
from biear_tpu_torch.train import loop as tloop
from biear_tpu_torch.train import optim as topt
from biear_tpu_torch.train.runner import dropout_streams, keyed_generator

# the synthesizer's geometry (fs 16000, 16 lags), dropout on
DROPOUT = dict(controller_mode="dual", deltaQ_mode="relative", n_bands=16,
               latent_dim=16, ctrl_hidden=16, timesteps=3, ctrl_dropout=0.1,
               backend_dropout=0.2)
BATCH, CHUNK_STEPS = 4, 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel-capture")
    torch.save(ActiveBiEAR(BiEARConfig(**DROPOUT)).init_weights_(1)
               .state_dict(), tmp / "w.pt")
    cfg_j = JaxConfig(**SMALL)
    params = init_active(jax.random.PRNGKey(0), cfg_j)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params),
                             BiEARConfig(**SMALL))
    torch.save(sd, tmp / "jw.pt")
    batches = _batches("active", seed=5)
    np.savez(tmp / "b.npz", n=len(batches[0]),
             **{f"b{i}_{j}": a for i, b in enumerate(batches)
                for j, a in enumerate(b)})
    launch(2, "capture", {
        "out": str(tmp), "cfg": DROPOUT, "weights": str(tmp / "w.pt"),
        "batch": BATCH, "chunk_steps": CHUNK_STEPS, "jax_cfg": SMALL,
        "jax_weights": str(tmp / "jw.pt"), "batches": str(tmp / "b.npz"),
        "steps": STEPS})
    out = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    out[0]["jax_init"], out[0]["jax_batches"] = sd, batches
    out[0]["jax_params"] = params
    return out


def _equal(a, b, where: str) -> None:
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        assert a.shape == b.shape and torch.equal(a, b), where


@pytest.mark.parametrize("rank", [0, 1])
def test_two_graph_chunk_and_step_equal_the_eager_mesh_path(ranks, rank):
    r = ranks[rank]
    assert r["captured"]["kinds"] == [True] * 4
    assert r["eager"]["kinds"] == [False] * 4
    for key in ("metrics", "params", "gen"):
        _equal(r["captured"][key], r["eager"][key], key)
    ms = r["captured"]["metrics"]
    assert ms[0]["loss"].shape == (CHUNK_STEPS,)
    assert all(float(m["skipped"].sum()) == 0 for m in ms)


def test_the_ranks_report_the_global_batch(ranks):
    _equal(ranks[0]["captured"]["metrics"], ranks[1]["captured"]["metrics"],
           "metrics")


@pytest.mark.parametrize("rank", [0, 1])
def test_captured_eval_step_and_chunk_equal_eager_under_a_mesh(ranks, rank):
    r = ranks[rank]
    for key in ("eval_step", "eval_chunk"):
        _equal(r["captured"][key], r["eager"][key], key)
    assert r["captured"]["eval_chunk"]["loss"].shape == (2,)


def test_split_all_reduce_equals_the_one_call_reduction(ranks):
    assert [r["split_reduce_equal"] for r in ranks] == [True, True]


@pytest.mark.parametrize("entry", ["step", "chunk", "eval_step",
                                     "eval_chunk"])
def test_capture_true_under_a_model_axis_raises(ranks, entry):
    for r in ranks:
        got = r["model_axis"][entry]
        assert got["raised"] is not None and "model axis" in got["raised"]
        assert got["default_eager"]


def test_use_capture_rules(monkeypatch):
    """The default captures on a card without a mesh or under D x 1, never
    under a model axis; capture=False stays eager; nothing on the CPU."""
    model = torch.nn.Linear(2, 2)
    mesh = lambda d, m: types.SimpleNamespace(data=d, model=m)
    assert cgraph.use_capture(model, mesh(2, 1), None) is False   # CPU
    with pytest.raises(ValueError, match="CUDA"):
        cgraph.use_capture(model, mesh(2, 1), True)
    monkeypatch.setattr(cgraph, "on_card", lambda _: True)
    for m, want in ((None, True), (mesh(2, 1), True), (mesh(1, 1), True),
                    (mesh(1, 2), False), (mesh(2, 2), False)):
        assert cgraph.use_capture(model, m, None) is want
        assert cgraph.use_capture(model, m, False) is False
    assert cgraph.use_capture(model, mesh(2, 1), True) is True
    with pytest.raises(ValueError, match="model axis"):
        cgraph.use_capture(model, mesh(2, 2), True)


@pytest.mark.parametrize("data_rank,model_rank,model", [
    (1, 0, 1), (0, 1, 2), (1, 1, 2), (3, 0, 1)])
def test_reseeded_dropout_streams_draw_what_fresh_generators_drew(
        data_rank, model_rank, model):
    mesh = types.SimpleNamespace(rank=data_rank * model + model_rank,
                                 data_rank=data_rank, model_rank=model_rank,
                                 model=model)
    shared = torch.Generator().manual_seed(0)
    streams = dropout_streams(mesh, shared, "cpu", 5, 1, 0)
    kept = streams.generators()
    for key in ((5, 1, 1), (5, 2, 0), (5, 1, 0)):
        again = dropout_streams(mesh, shared, "cpu", *key, streams=streams)
        assert again is streams and all(
            a is b for a, b in zip(again.generators(), kept))
        rep = (shared if data_rank == 0
               else keyed_generator("cpu", *key, data_rank))
        cut = (rep if model == 1
               else keyed_generator("cpu", *key, data_rank, model_rank))
        assert (streams.replicated is shared) == (data_rank == 0)
        assert (streams.sharded is streams.replicated) == (model == 1)
        for got, want in ((streams.replicated, rep), (streams.sharded, cut)):
            if want is shared:
                continue
            assert torch.equal(got.get_state(), want.get_state())
            assert torch.equal(torch.rand(5, generator=got),
                               torch.rand(5, generator=want))
    assert dropout_streams(types.SimpleNamespace(rank=0), shared, "cpu",
                           1) is None


@pytest.mark.parametrize("family", ["dual-bf16", "passive"])
def test_warm_halves_make_no_host_sync_or_constant(family, monkeypatch):
    """A rank's send and receive halves (synthesis included, dropout from
    a data rank's streams, lr_scale a device tensor) after one warm step:
    no op that reads a device value on the host, no host array made a
    tensor; the send half writes the same buffer every call."""
    torch.set_num_threads(1)
    model, synth = _family(family)
    hp = topt.TrainHyper()
    send, receive = tloop.step_halves(model, hp,
                                      topt.make_optimizer(model, hp), 200)
    gen = torch.Generator().manual_seed(0)
    rep = keyed_generator("cpu", 0, 1)
    drop = RankGenerators(gen, rep, rep)
    batch_fn, lr = synth.batch_fn(2), torch.tensor(0.5)
    first = send(batch_fn(gen), drop)
    receive(first, lr)
    with watching_host(monkeypatch) as (watch, calls):
        flat = send(batch_fn(gen), drop)
        ms = receive(flat, lr)
    assert watch.ops > 500
    assert dict(watch.syncs) == {}
    assert dict(calls) == {}
    assert flat is first
    assert float(ms["skipped"]) == 0.0


@pytest.fixture(scope="module")
def jax_trajectory(ranks):
    if len(jax.devices()) < 2:
        pytest.fail("tests/conftest.py gives JAX 8 CPU devices; found "
                    f"{len(jax.devices())}")
    mesh = make_mesh(2, 1, devices=jax.devices()[:2])
    hp = JaxHyper()
    with jax.default_matmul_precision("highest"):
        p = shard_params(ranks[0]["jax_params"], mesh)
        opt = jax_optimizer(p, hp)
        state = shard_opt_state(opt.init(p), p, mesh)
        step = jax_train_step(JaxConfig(**SMALL), hp, opt, "active")
        losses, norms = [], []
        for b in ranks[0]["jax_batches"]:
            b = tuple(jax.device_put(a, batch_sharding(mesh)) for a in b)
            p, state, m = step(p, state, b, jax.random.PRNGKey(7),
                               jnp.float32(1.0))
            losses.append(float(m["loss"]))
            norms.append([float(m["grad_fb_norm"]),
                          float(m["grad_backend_norm"])])
            assert float(m["skipped"]) == 0.0
    return {"losses": losses, "norms": norms,
            "params": state_dict_from_jax(jax.tree.map(np.asarray, p),
                                          BiEARConfig(**SMALL))}


@pytest.mark.parametrize("what", ["losses", "params", "norms"])
def test_captured_mesh_step_matches_jax_on_its_mesh(ranks, jax_trajectory,
                                                    what):
    want = jax_trajectory
    for r in ranks:
        got = r["jax_steps"]
        assert got["captured"]
        assert [s["skipped"] for s in got["steps"]] == [0.0] * STEPS
        if what == "losses":
            np.testing.assert_allclose([s["loss"] for s in got["steps"]],
                                       want["losses"], rtol=LOSS_RTOL)
        elif what == "norms":
            np.testing.assert_allclose(
                [[s["grad_fb_norm"], s["grad_backend_norm"]]
                 for s in got["steps"]], want["norms"], rtol=NORM_RTOL)
        else:
            diffs = {k: float((got["params"][k] - v).abs().max())
                     for k, v in want["params"].items()}
            assert max(diffs.values()) < PARAM_TOL
            assert update_distance(got["params"], want["params"],
                                   ranks[0]["jax_init"]) < UPDATE_TOL
