"""The benchmark's plain reference of the single-controller model
(``perfbench/reference/single.py``) against the port's single model on
the CPU, and the cell ``single-train-b512`` through the harness at a
tiny size.

The reference and the port share seeded weights (the reference's
``param_specs`` drawn by ``make_params``, loaded strict into the port),
one batch and one dropout generator; both run in training mode, so the
controller's keep-masks are drawn and applied alike."""

import contextlib
import dataclasses
import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "perfbench", "tests"))
import tiny  # noqa: E402

from biear_tpu_torch.models import BiEARConfig, build_active  # noqa: E402
from biear_tpu_torch.train import loop as tloop  # noqa: E402
from biear_tpu_torch.train.optim import TrainHyper  # noqa: E402
from perfbench import faults, harness  # noqa: E402
from perfbench.reference import model as ref_model  # noqa: E402
from perfbench.reference import single  # noqa: E402

# the geometry of tests/test_torch_port_single.py: conf/config_single_ctrl
# .yaml's controller at a small width
SMALL = dict(controller_mode="single", deltaQ_mode="absolute",
             deltaQ_base=2.0, deltaQ_low_factor=0.5, deltaQ_high_factor=5.0,
             fs=1600, timesteps=5, n_fft=256, n_bands=24, fmin=50.0,
             fmax=700.0, latent_dim=16, ctrl_hidden=16)
B = 3
HP = {k: v for k, v in tiny.load(tiny.BENCH_DIR, "configs",
                                  "biear-single.json")["train"].items()
      if k != "max_param_log"}
# Tolerances, from perfbench/tests/test_perfbench_reference.py's SOUND
# (the port's CPU step against the reference through the harness):
#   loss: 1e-4 relative, its loss_gap (under f32 both sides differ by the
#     order of their sums alone, about 1e-7);
#   gradients: each leaf's |g - g_ref| over max(|g_ref|, the median
#     leaf's |g_ref|) within 0.05, its grad_gap (bfloat16 operands: a
#     rounding flip of G moves a few small leaves);
#   Q: the largest |Q - Q_ref| over the Q range within 1e-4 (f32) and
#     1e-3 (bfloat16): Q is tanh of the controller's output times deltaQ,
#     so a rounding flip in Y moves it by about the controller's gain
#     times bfloat16's 2^-8 relative step, far below its 1e-3.
TOL = {"float32": {"loss": 1e-4, "grad": 0.05, "q": 1e-4},
       "bfloat16": {"loss": 1e-4, "grad": 0.05, "q": 1e-3}}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(dtype: str, seed: int = 3):
    """(reference cfg, its parameters, the port's model with them)."""
    cfg = BiEARConfig(**SMALL, fb_w_dtype=dtype)
    rcfg = dict(dataclasses.asdict(cfg), family="active")
    P = ref_model.make_params(single.param_specs(rcfg),
                              torch.Generator().manual_seed(seed))
    model = build_active(cfg, device="cpu")
    model.load_state_dict(P, strict=True)
    return rcfg, P, model


def _batch(seed: int = 5):
    g = torch.Generator().manual_seed(seed)
    wav = (torch.rand((2, B, SMALL["fs"]), generator=g) * 2 - 1) * 0.5
    x3 = torch.rand((B, SMALL["n_bands"]), generator=g)
    y = torch.zeros((B, ref_model.N_SECTORS, 7))
    y[:, :, 0] = (torch.rand((B, ref_model.N_SECTORS), generator=g)
                  < 0.4).float()
    y[:, :, 1] = torch.rand((B, ref_model.N_SECTORS), generator=g)
    y[:, :, 2] = 1.0
    return wav[0], wav[1], x3, y.reshape(B, -1)


def test_param_specs_are_the_ports_state_dict_keys():
    rcfg, P, model = _pair("float32")
    assert list(P) == [s[0] for s in single.param_specs(rcfg)]
    sd = model.state_dict()
    assert set(P) == set(sd)
    assert all(tuple(P[k].shape) == tuple(sd[k].shape) for k in P)
    assert P["bifb.q_rnn.weight_ih_l0"].shape[1] == 4 * SMALL["n_bands"]
    assert not any(k.startswith(("bifb.fb_L", "bifb.fb_R")) for k in P)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_the_ports_single_model(dtype):
    """Loss, every leaf's gradient and the Q trajectory (B, T, N) of one
    training forward and backward."""
    rcfg, P, model = _pair(dtype)
    batch = _batch()
    model.train()
    params = dict(model.named_parameters())
    loss, _ = tloop.model_loss(model, TrainHyper(**HP), batch,
                               torch.Generator().manual_seed(9))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                 allow_unused=True)))
    with torch.no_grad():
        wl, wr, x3 = ref_model.sanitize(*batch[:3])
        q_port = model(wl, wr, x3, gen=torch.Generator().manual_seed(9))[3]
    c = ref_model.constants(rcfg, "cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in P.items()}
    ref_loss = single.loss(rcfg, HP, c, leaves, batch,
                           torch.Generator().manual_seed(9))
    ref_grads = dict(zip(leaves, torch.autograd.grad(
        ref_loss, list(leaves.values()), allow_unused=True)))
    with torch.no_grad():
        q_ref = single.single_forward(rcfg, c, P, wl, wr, x3,
                                      torch.Generator().manual_seed(9))[3]
    tol = TOL[dtype]
    loss, ref_loss = float(loss.detach()), float(ref_loss.detach())
    assert abs(loss - ref_loss) <= tol["loss"] * abs(ref_loss)
    norms = {k: float(v.norm()) for k, v in ref_grads.items()
             if v is not None}
    med = float(torch.tensor(list(norms.values())).median())
    assert set(norms) == set(P)
    for k, g in grads.items():
        gap = float((g - ref_grads[k]).norm()) / max(norms[k], med)
        assert gap <= tol["grad"], (k, gap)
    q = q_port["Q"]
    assert q.shape == q_ref.shape == (B, SMALL["timesteps"],
                                      SMALL["n_bands"])
    assert float((q_ref - q_ref[:, :1]).abs().max()) > 0      # Q adapts
    span = float(q_ref.max() - q_ref.min())
    assert float((q - q_ref).abs().max()) <= tol["q"] * span


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    """The tiny benchmark copy with the cell's traffic mix at a tiny size."""
    d = tiny.make(str(tmp_path_factory.mktemp("tiny") / "b"))
    mix = dict(tiny.TINY_MIX["anechoic-b512"], driver="train_chunk_single")
    with open(os.path.join(d, "traffic", "anechoic-b512-single.json"),
              "w") as f:
        json.dump(mix, f)
    return d


@pytest.mark.parametrize("fault", [None, "half the batch"])
def test_the_cell_through_the_harness(fault, bench_dir):
    """A sound run is correct (its checked numbers within the cell's
    limits, which are set at batch 512); with half the batch left out it
    is not. The seeds are those of perfbench/tests/test_perfbench_
    reference.py (sound 11, faults 12): at 2 rows the worst leaf's
    gradient gap swings with the draw (0.006-0.16 over five seeds under
    bfloat16 operands, 1e-4-0.03 under float32)."""
    plant = faults.plant(fault) if fault else contextlib.nullcontext()
    with plant:
        out = harness.run("single-train-b512", 12 if fault else 11, 0.2,
                          False, "cpu", tiny.benchmark(), bench_dir=bench_dir)
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["correct"] is (fault is None), out["checks"]
    assert set(out["metrics"]) == {"train_utt_s", "setup_s"}
