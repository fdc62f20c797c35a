"""The port's ``make_eval_chunk`` and the runner's stacked eval splits,
checked on the CPU against the JAX package.

  * ``train.loop.make_eval_chunk`` (eager on the CPU: a loop over the
    stack's rows) against JAX's ``biear_tpu.train.loop.make_eval_chunk``
    (one ``lax.scan``) on the same stacked batches and weights, for the
    dual-controller, passive and AuralNet models: the loss to
    tests/test_sharding.py's ``rtol=2e-4, atol=1e-6`` (LOSS_RTOL,
    LOSS_ATOL), the other metrics to the port's eval-step parity tolerance
    (METRIC_ATOL, tests/test_torch_port_train.py::test_eval_step_matches_jax);
    each row equals the eval step on that batch bit for bit;
  * ``SynthEvalDataset.stacked_groups``: the split's batches grouped by
    shape, ``device_batches()`` yielding the same rows group by group,
    the per-batch list dropped, and a spilled split with no groups (as
    JAX's, tests/test_runner_variants.py);
  * the runner's stacked eval against its per-batch eval on the same
    training run: equal split metrics (to the float rounding of the sums'
    order, SUM_RTOL).

The captured chunk on the card: tests/test_torch_port_serve_capture_card.py
and ``chip_smoke.py`` phase 19.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biear_tpu.models import BiEARConfig as JaxConfig
from biear_tpu.models.auralnet import init_auralnet
from biear_tpu.models.biear import init_active, init_passive
from biear_tpu.train import loop as jloop

from biear_tpu_torch import config as tcfg
from biear_tpu_torch import train_biear
from biear_tpu_torch.data import synth as tsy
from biear_tpu_torch.models import (ActiveBiEAR, AuralNet, BiEARConfig,
                                    PassiveBiEAR)
from biear_tpu_torch.models.weights import state_dict_from_jax
from biear_tpu_torch.train import loop as tloop
from biear_tpu_torch.train import optim as topt
from biear_tpu_torch.train import runner as trun

import _torch_runner_common as C

LOSS_RTOL, LOSS_ATOL = 2e-4, 1e-6    # tests/test_sharding.py:236
METRIC_ATOL = 2e-5                   # the port's eval-step parity
SUM_RTOL = 1e-6                      # split means summed in another order
N_BATCHES, B = 3, 4
FAMILIES = {
    "dual": (dict(fs=1600, timesteps=4, n_fft=256, n_bands=24, fmin=50.0,
                  fmax=700.0, latent_dim=24, deltaQ_mode="relative"),
             init_active, ActiveBiEAR, "active"),
    "passive": (dict(n_bands=16, timesteps=5, latent_dim=16,
                     ctrl_dropout=0.0, backend_dropout=0.0),
                init_passive, PassiveBiEAR, "passive"),
    "auralnet": (dict(fixed_frontend_q=True, deltaQ_mode="absolute",
                      deltaQ_base=2.0, deltaQ_low_factor=0.5,
                      deltaQ_high_factor=1.0, fs=16000, timesteps=5,
                      n_bands=24, d_model=32, attn_heads=4, attn_layers=2),
                 init_auralnet, AuralNet, "auralnet"),
}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _targets(rng, n):
    y = np.zeros((n, 8, 7), np.float32)
    y[:, :, 2] = 1.0
    for b in range(n):
        for s in rng.choice(8, size=rng.integers(1, 4), replace=False):
            y[b, s, :2] = (1.0, rng.uniform())
            y[b, s, 2:] = 0.0
            y[b, s, 2 + rng.integers(1, 5)] = 1.0
    return y.reshape(n, 56)


def _stacks(family, cfg, weighted, seed=0):
    """(N_BATCHES, B, ...) numpy stacks of the family's batch fields."""
    rng = np.random.default_rng(seed)
    n = N_BATCHES * B
    if family == "passive":
        tb = (n, cfg.timesteps, cfg.n_bands)
        fields = [rng.uniform(-80, 0, tb), rng.uniform(-80, 0, tb),
                  rng.uniform(-1, 1, (n, cfg.n_bands)),
                  rng.uniform(-np.pi, np.pi, tb),
                  rng.uniform(-np.pi, np.pi, tb)]
    else:
        fields = [rng.uniform(-1, 1, (n, cfg.fs)),
                  rng.uniform(-1, 1, (n, cfg.fs)),
                  rng.uniform(-1, 1, (n, cfg.n_bands))]
    fields.append(_targets(rng, n))
    if weighted:                 # a padded batch: weight-0 rows
        fields.append((rng.uniform(size=n) > 0.3).astype(np.float32))
    return tuple(a.astype(np.float32).reshape(N_BATCHES, B, *a.shape[1:])
                 for a in fields)


def _pair(family, seed=0):
    kw, init, cls, kind = FAMILIES[family]
    cfg_j, cfg_t = JaxConfig(**kw), BiEARConfig(**kw)
    params = init(jax.random.PRNGKey(seed), cfg_j)
    model = cls(cfg_t)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), cfg_t), strict=True)
    return cfg_j, params, model, kind


@pytest.mark.parametrize("family,weighted", [
    ("dual", False), ("dual", True), ("passive", False),
    ("auralnet", False)])
def test_eval_chunk_matches_jax(family, weighted):
    cfg_j, params, model, kind = _pair(family, seed=3)
    stacks = _stacks(family, model.cfg, weighted, seed=4)
    hp = topt.TrainHyper()
    with jax.default_matmul_precision("highest"):
        want = jloop.make_eval_chunk(cfg_j, hp, kind)(
            params, tuple(jnp.asarray(a) for a in stacks))
    chunk = tloop.make_eval_chunk(model, hp)
    got = chunk(tuple(torch.as_tensor(a) for a in stacks))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (N_BATCHES,), k
        tol = (dict(rtol=LOSS_RTOL, atol=LOSS_ATOL) if k == "loss"
               else dict(rtol=0, atol=METRIC_ATOL))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **tol)
    # each row is the eval step on that batch, bit for bit
    step = tloop.make_eval_step(model, hp)
    for r in range(N_BATCHES):
        m = step(tuple(torch.as_tensor(a[r]) for a in stacks))
        assert all(torch.equal(m[k], got[k][r]) for k in m)


def test_eval_chunk_capture_on_the_cpu_raises_and_the_default_is_eager():
    _, _, model, _ = _pair("dual")
    hp = topt.TrainHyper()
    for make in (tloop.make_eval_chunk, tloop.make_eval_step):
        with pytest.raises(ValueError, match="CUDA device"):
            make(model, hp, capture=True)
    stacks = tuple(torch.as_tensor(a)
                   for a in _stacks("dual", model.cfg, False))
    a = tloop.make_eval_chunk(model, hp)(stacks)
    b = tloop.make_eval_chunk(model, hp, capture=False)(stacks)
    assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------- the stacked split ----------------

def _synth():
    return tsy.build_synthesizer("anechoic", None,
                                 tsy.make_test_segments(4), 16000,
                                 num_lags=24, device="cpu")


@pytest.mark.parametrize("n,batch,thirds", [(20, 4, True), (10, 4, False),
                                            (14, 4, True)])
def test_stacked_groups_hold_the_split_by_shape(n, batch, thirds):
    """Kept on the device, the split's batches (the spilled split's, in
    order) are stacked by row count in order of first appearance, as
    JAX's; device_batches() yields them group by group; the per-batch
    list is gone; a spilled split has no stacked groups."""
    sy = _synth()
    kept = trun.SynthEvalDataset(sy, n, 5, batch, test_thirds=thirds,
                                 keep_on_device=True)
    spilled = trun.SynthEvalDataset(sy, n, 5, batch, test_thirds=thirds,
                                    keep_on_device=False)
    assert spilled.stacked_groups == [] and kept._batches is None
    order = list(spilled.device_batches())
    rows = list(dict.fromkeys(b[0].shape[0] for b in order))
    assert [g[0].shape[:2] for g in kept.stacked_groups] == [
        (sum(b[0].shape[0] == r for b in order), r) for r in rows]
    want = [b for r in rows for b in order if b[0].shape[0] == r]
    got = list(kept.device_batches())
    assert len(got) == len(want) == len(order)
    for a, b in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for g in kept.stacked_groups:
        assert len(g) == len(order[0])
    assert len(kept) == len(spilled) == n


# ---------------- the runner ----------------

def _synth_rc(tmp_path, on_device: bool):
    rc = tcfg.load_run_config(C.CONF)
    rc.runs_root, rc.epochs, rc.batch_size = str(tmp_path), 2, 2
    rc.synth_on_device, rc.print_every, rc.hist_every = True, 100, 100
    rc.raw = dict(rc.raw, SYNTH_STEPS_PER_EPOCH=2, SYNTH_CHUNK_STEPS=2,
                  SYNTH_EVAL_SAMPLES=7, SYNTH_EVAL_ON_DEVICE=on_device)
    rc.model_cfg = BiEARConfig(n_bands=16, timesteps=3, latent_dim=16,
                               ctrl_hidden=16, deltaQ_mode="relative")
    return rc


def test_runner_stacked_eval_equals_its_per_batch_eval(tmp_path):
    """The same run with its eval splits kept on the device (stacked, one
    ``make_eval_chunk`` call per group: 3 x 2 + 1 rows) and spilled to
    the host (per batch through the eval step): training equal bit for
    bit, every val and test metric equal to SUM_RTOL."""
    runs = {}
    with C.small_cpu():
        for on_device in (True, False):
            rc = _synth_rc(tmp_path / str(on_device), on_device)
            synth = train_biear.make_synth(rc, "cpu")
            runs[on_device] = trun.train(rc, synth=synth, run_id="E",
                                         quiet=True, device="cpu")
    a, b = runs[True], runs[False]
    for k, v in a["model"].state_dict().items():
        assert torch.equal(v, b["model"].state_dict()[k]), k
    for split in ("train", "val"):
        for ea, eb in zip(a["history"][split], b["history"][split]):
            assert set(ea) == set(eb)
            for k in ea:
                if k != "sec":
                    assert ea[k] == pytest.approx(eb[k], rel=SUM_RTOL,
                                                  abs=0), (split, k)
    assert set(a["test"]) == set(b["test"])
    for k in a["test"]:
        if k != "sec":
            assert a["test"][k] == pytest.approx(b["test"][k], rel=SUM_RTOL,
                                                 abs=0), k
    assert all(np.isfinite(e["loss"]) for e in a["history"]["val"])
