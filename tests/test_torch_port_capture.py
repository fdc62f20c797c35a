"""The captured train step's contract, checked on the CPU.

On the card ``make_train_step`` and ``make_train_chunk`` replay CUDA
graphs (``biear_tpu_torch/train/graph.py``); this machine has no card, so
these tests hold what a capture needs and what the CPU can show:

  * after one warm step a train step (synthesis included) makes no host
    sync and copies no host constant, for every model family: a
    ``TorchDispatchMode`` rejects ``aten._local_scalar_dense``,
    ``aten.nonzero`` and ``aten.masked_select``, and ``torch.as_tensor``,
    ``torch.from_numpy`` and ``torch.tensor`` are counted;
  * ``lr_scale`` as a 0-dim tensor gives the float's trajectory bit for
    bit and JAX ``make_train_step``'s at the trajectory limits of
    tests/test_torch_port_train.py (loss 5e-5, parameters 3e-3); 0 leaves
    the parameters;
  * the runner's re-seeded generator draws what a generator made per
    chunk drew;
  * the cached device constants equal fresh builds;
  * ``capture=True`` on the CPU raises;
  * the launch counters count a graph's kernels once per replay, and the
    capture logic (warm-up, restore, replays, the metric stacks) gives the
    eager loop's bits, with a stand-in for the CUDA graph that runs the
    captured function at each replay.

The card's own checks (capture against the eager loop) are
tests/test_torch_port_capture_card.py and ``chip_smoke.py`` phase 18.
"""

import collections
import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from biear_tpu.models import BiEARConfig as JaxConfig
from biear_tpu.models.biear import init_active
from biear_tpu.train import loop as jloop
from biear_tpu.train import optim as jopt

from _torch_graph_stand_in import install as install_stand_ins

from biear_tpu_torch import graph as cgraph
from biear_tpu_torch import kernels
from biear_tpu_torch.data.passive_synth import PassiveFeatureSynth
from biear_tpu_torch.device import matmul_precision
from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                        build_synthesizer,
                                        make_test_hrir_bank,
                                        make_test_segments)
from biear_tpu_torch.kernels import (LAUNCHES, count_launch, count_replay,
                                     recording_launches)
from biear_tpu_torch.models import (ActiveBiEAR, BiEARConfig, build_active,
                                    build_auralnet, build_passive)
from biear_tpu_torch.models.auralnet import device_pe, sinusoidal_pe
from biear_tpu_torch.models.frontend import (device_constants,
                                             frontend_constants)
from biear_tpu_torch.models.weights import state_dict_from_jax
from biear_tpu_torch.ops.xcorr import device_lag_plan, lag_plan
from biear_tpu_torch.serve.profile_serve import AURALNET
from biear_tpu_torch.train import graph as tgraph
from biear_tpu_torch.train import loop as tloop
from biear_tpu_torch.train import optim as topt
from biear_tpu_torch.train.runner import keyed_generator, keyed_seed

HOST_SYNCS = {"aten._local_scalar_dense.default", "aten.nonzero.default",
              "aten.masked_select.default"}
HOST_CONSTANTS = ("as_tensor", "from_numpy", "tensor")
SMALL = dict(n_bands=16, latent_dim=16, ctrl_hidden=16, timesteps=3)
TINY = dict(fs=1600, timesteps=4, n_fft=256, n_bands=24, fmin=50.0,
            fmax=700.0, latent_dim=24, deltaQ_mode="relative")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class HostWatch(TorchDispatchMode):
    """Counts every op dispatched in the block and each host sync."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.syncs = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        if str(func) in HOST_SYNCS:
            self.syncs[str(func)] += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def watching_host(monkeypatch):
    """(HostWatch, {name: calls of torch.<name>}) over the block."""
    calls = collections.Counter()
    for name in HOST_CONSTANTS:
        orig = getattr(torch, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(torch, name, counted)
    try:
        with HostWatch() as watch:
            yield watch, calls
    finally:
        monkeypatch.undo()


def _anechoic(mix_dtype="bfloat16"):
    ir, az, dist = make_test_hrir_bank()
    return AnechoicSynthesizer(ir, az, dist, make_test_segments(8),
                               num_lags=16, mix_dtype=mix_dtype,
                               device="cpu")


def _family(name):
    """(model, synthesizer) of one family at a small width, on the CPU."""
    if name == "passive":
        cfg = BiEARConfig(n_bands=16, timesteps=5, latent_dim=16)
        return (build_passive(cfg, device="cpu"),
                PassiveFeatureSynth(_anechoic(), data_dim=16, timesteps=5))
    if name == "auralnet":
        cfg = BiEARConfig(**dict(AURALNET, n_bands=16, timesteps=3,
                                 d_model=32))
        return build_auralnet(cfg, device="cpu"), _anechoic()
    if name == "spirit":
        synth = build_synthesizer("spirit", None, make_test_segments(4),
                                  16000, num_lags=16, device="cpu")
        cfg = BiEARConfig(controller_mode="dual", deltaQ_mode="relative",
                          **SMALL)
        return build_active(cfg, device="cpu"), synth
    mode, dtype = {"dual-bf16": ("dual", "bfloat16"),
                   "dual-f32": ("dual", "float32"),
                   "single": ("single", "bfloat16")}[name]
    cfg = BiEARConfig(controller_mode=mode, deltaQ_mode="relative",
                      fb_w_dtype=dtype, **SMALL)
    return build_active(cfg, device="cpu"), _anechoic(dtype)


# ---------------- no host sync, no host constant ----------------

@pytest.mark.parametrize("family", ["dual-bf16", "dual-f32", "single",
                                    "passive", "auralnet", "spirit"])
def test_a_warm_train_step_makes_no_host_sync_or_constant(family,
                                                          monkeypatch):
    """A fused synthesize -> train step after one warm step: no op that
    reads a device value on the host, no host array made a tensor (each
    would stall or break a captured graph on the card)."""
    model, synth = _family(family)
    hp = topt.TrainHyper()
    chunk = tloop.make_train_chunk(model, hp, topt.make_optimizer(model, hp),
                                   synth.batch_fn(2), 1)
    gen = torch.Generator().manual_seed(0)
    chunk(gen)
    with watching_host(monkeypatch) as (watch, calls):
        ms = chunk(gen)
    assert watch.ops > 500                      # it saw the whole step
    assert dict(watch.syncs) == {}
    assert dict(calls) == {}
    assert float(ms["skipped"].sum()) == 0.0


def test_the_watch_sees_syncs_and_constants(monkeypatch):
    with watching_host(monkeypatch) as (watch, calls):
        torch.ones(3).sum().item()
        torch.nonzero(torch.ones(3))
        torch.as_tensor(np.zeros(2, np.float32))
    assert watch.syncs["aten._local_scalar_dense.default"] == 1
    assert watch.syncs["aten.nonzero.default"] == 1
    assert calls["as_tensor"] == 1


# ---------------- lr_scale as a tensor operand ----------------

def _tiny_batches(rng, cfg, n=3, B=4):
    out = []
    for _ in range(n):
        wav = rng.uniform(-1, 1, (2, B, cfg.fs)).astype(np.float32)
        x3 = rng.uniform(-1, 1, (B, cfg.n_bands)).astype(np.float32)
        y = np.zeros((B, 8, 7), np.float32)
        y[:, :, 2] = 1.0
        for b in range(B):
            s = rng.integers(0, 8)
            y[b, s, :3] = (1.0, rng.uniform(), 0.0)
            y[b, s, 3 + rng.integers(0, 4)] = 1.0
        out.append((wav[0], wav[1], x3, y.reshape(B, 56)))
    return out


def _state(model, opt):
    return [t.detach().clone() for t in tgraph.train_state(model, opt)]


def test_tensor_lr_scale_gives_the_float_trajectory_bit_for_bit():
    cfg = BiEARConfig(**TINY, ctrl_dropout=0.1, backend_dropout=0.2)
    batches = _tiny_batches(np.random.default_rng(1), cfg)
    hp = topt.TrainHyper()
    runs = []
    for lr in (0.5, torch.tensor(0.5)):
        model = ActiveBiEAR(cfg).init_weights_(3)
        opt = topt.make_optimizer(model, hp)
        step = tloop.make_train_step(model, hp, opt)
        gen = torch.Generator().manual_seed(7)
        ms = [step(tuple(torch.as_tensor(a) for a in b), gen, lr)
              for b in batches]
        runs.append((ms, _state(model, opt)))
    (m_f, s_f), (m_t, s_t) = runs
    for a, b in zip(s_f, s_t):
        assert torch.equal(a, b)
    for a, b in zip(m_f, m_t):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_tensor_lr_scale_matches_jax_make_train_step():
    """Three steps at lr_scale 0.5, a 0-dim tensor in the port and an f32
    operand in JAX: loss 5e-5, parameters 3e-3."""
    kw = dict(TINY, ctrl_dropout=0.0, backend_dropout=0.0)
    cfg_j, cfg_t = JaxConfig(**kw), BiEARConfig(**kw)
    params = init_active(jax.random.PRNGKey(0), cfg_j)
    model = ActiveBiEAR(cfg_t)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), cfg_t), strict=True)
    batches = _tiny_batches(np.random.default_rng(10), cfg_t)
    hp = topt.TrainHyper()

    opt_j = jopt.make_optimizer(params, hp)
    state_j = opt_j.init(params)
    step_j = jloop.make_train_step(cfg_j, hp, opt_j, "active")
    params_j = jax.tree.map(jnp.copy, params)
    losses_j = []
    with jax.default_matmul_precision("highest"):
        for i, b in enumerate(batches):
            params_j, state_j, m = step_j(
                params_j, state_j, tuple(jnp.asarray(a) for a in b),
                jax.random.PRNGKey(i), jnp.float32(0.5))
            losses_j.append(float(m["loss"]))

    opt = topt.make_optimizer(model, hp)
    step = tloop.make_train_step(model, hp, opt)
    gen, lr = torch.Generator(), torch.tensor(0.5)
    losses_t = [float(step(tuple(torch.as_tensor(a) for a in b), gen,
                           lr)["loss"]) for b in batches]
    assert np.abs(np.array(losses_t) - np.array(losses_j)).max() < 5e-5
    want = state_dict_from_jax(jax.tree.map(np.asarray, params_j), cfg_t)
    got = model.state_dict()
    assert max(float((got[k] - want[k]).abs().max()) for k in want) < 3e-3


def test_lr_scale_zero_leaves_the_parameters():
    cfg = BiEARConfig(**TINY)
    model = ActiveBiEAR(cfg).init_weights_(5)
    hp = topt.TrainHyper()
    opt = topt.make_optimizer(model, hp)
    batch = tuple(torch.as_tensor(a) for a in
                  _tiny_batches(np.random.default_rng(2), cfg, n=1)[0])
    before = [p.detach().clone() for p in model.parameters()]
    m = tloop.train_step(model, hp, opt, batch, torch.Generator(),
                         torch.zeros(()))
    assert float(m["skipped"]) == 0.0
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    assert all(int(g.count) == 1 for g in opt.groups)
    assert any(float(t.abs().max()) > 0 for g in opt.groups for t in g.m)


# ---------------- the runner's generator ----------------

def test_the_reseeded_generator_draws_what_a_keyed_generator_drew():
    """One generator re-seeded per chunk (the runner's, which a captured
    chunk is registered with) gives the batches and the dropout draws of
    a generator made per chunk from the same key."""
    synth = _anechoic()
    one = torch.Generator()
    for key in ((0, 1, 0), (0, 1, 1), (3, 2, 5)):
        fresh = keyed_generator("cpu", *key)
        one.manual_seed(keyed_seed(*key))
        for _ in range(2):
            a, b = synth.sample_batch(one, 3), synth.sample_batch(fresh, 3)
            assert all(torch.equal(x, y) for x, y in zip(a, b))
            assert torch.equal(torch.rand(5, generator=one),
                               torch.rand(5, generator=fresh))


# ---------------- cached constants ----------------

def test_cached_device_constants_equal_fresh_builds():
    cfg = BiEARConfig(**SMALL)
    c = device_constants(cfg, "cpu")
    assert c is device_constants(cfg, torch.device("cpu"))
    for k, v in frontend_constants(cfg).items():
        if isinstance(v, np.ndarray):
            assert torch.equal(c[k], torch.as_tensor(v)), k
        else:
            assert c[k] == v, k
    for n in (16000, 1000):                  # kernel and rFFT paths
        kept, j0, w = lag_plan(n, 16000, 100, 3.0)
        tj0, tw, idx = device_lag_plan(n, 16000, 100, 3.0,
                                       torch.device("cpu"))
        assert torch.equal(tj0, torch.as_tensor(j0))
        assert torch.equal(tw, torch.as_tensor(w))
        if n % 128:
            fft_len = 2048                 # >= n + max |kept| (48)
            assert torch.equal(idx, torch.as_tensor(np.mod(kept, fft_len)))
        else:
            assert idx is None
    assert torch.equal(device_pe(19, 32, torch.device("cpu")),
                       torch.as_tensor(sinusoidal_pe(19, 32)))
    assert torch.equal(tloop._device_edges(torch.device("cpu")),
                       torch.as_tensor(tloop.GRAD_HIST_EDGES))


def test_constants_first_built_in_inference_mode_still_train():
    """Serving builds the cached constants under ``torch.inference_mode``;
    a train step in the same process must still save them for its
    backward (an inference tensor cannot be)."""
    from biear_tpu_torch.models import frontend
    from biear_tpu_torch.ops import features
    from biear_tpu_torch.serve.infer import predict
    caches = (frontend._device_constants, device_lag_plan, device_pe,
              tloop._device_edges, features._device_consts)
    model, synth = _family("dual-bf16")
    for c in caches:
        c.cache_clear()
    batch = synth.sample_batch(torch.Generator().manual_seed(0), 2)
    with torch.inference_mode():
        predict(model, batch[0].numpy(), batch[1].numpy())
        features.passive_features(batch[0], data_dim=16, timesteps=5)
        device_pe(3, 32, torch.device("cpu"))
        tloop._device_edges(torch.device("cpu"))
    hp = topt.TrainHyper()
    m = tloop.train_step(model, hp, topt.make_optimizer(model, hp), batch,
                         torch.Generator())
    assert float(m["skipped"]) == 0.0
    assert not device_constants(model.cfg, "cpu")["Q0"].is_inference()


# ---------------- where the capture runs ----------------

def test_capture_on_the_cpu_raises_and_the_default_is_eager():
    model, synth = _family("dual-bf16")
    hp = topt.TrainHyper()
    opt = topt.make_optimizer(model, hp)
    with pytest.raises(ValueError, match="CUDA device"):
        tloop.make_train_step(model, hp, opt, capture=True)
    with pytest.raises(ValueError, match="CUDA device"):
        tloop.make_train_chunk(model, hp, opt, synth.batch_fn(2), 1,
                               capture=True)
    for capture in (None, False):
        step = tloop.make_train_step(model, hp, opt, capture=capture)
        chunk = tloop.make_train_chunk(model, hp, opt, synth.batch_fn(2), 1,
                                       capture=capture)
        assert not isinstance(step, tgraph.CapturedStep)
        assert not isinstance(chunk, tgraph.CapturedChunk)


# ---------------- launch counts under replay ----------------

def test_a_graph_counts_its_kernels_once_per_replay():
    LAUNCHES.clear()
    with recording_launches() as rec:
        count_launch("cc_lags")
        count_launch("gather_mix_kb")
    assert sum(LAUNCHES.values()) == 0      # recorded, not run
    for _ in range(3):
        count_replay(rec)
    assert LAUNCHES["cc_lags"] == 3 and LAUNCHES["gather_mix_kb"] == 3
    count_launch("cc_lags")                 # outside a capture: run now
    assert LAUNCHES["cc_lags"] == 4 and not kernels._recording
    LAUNCHES.clear()


class _FakeCUDAGraph:
    replays = 0

    def replay(self):
        _FakeCUDAGraph.replays += 1


def test_graph_replay_counts_and_refuses_new_storage():
    """``Graph.replay`` with a stand-in for the CUDA graph: one replay
    adds the recorded launches; a state tensor given new storage makes it
    raise before the graph runs."""
    p = torch.nn.Parameter(torch.ones(4))
    g = object.__new__(cgraph.Graph)
    g.graph, g.state = _FakeCUDAGraph(), [p]
    g.launches = collections.Counter(cc_lags=1, gather_windows=1)
    g._ptrs = [p.data_ptr()]
    LAUNCHES.clear()
    g.replay()
    assert _FakeCUDAGraph.replays == 1 and dict(LAUNCHES) == {
        "cc_lags": 1, "gather_windows": 1}
    kept = p.data
    p.data = kept.clone()
    with pytest.raises(RuntimeError, match="new storage"):
        g.replay()
    assert _FakeCUDAGraph.replays == 1 and LAUNCHES["cc_lags"] == 1
    p.data = kept
    g.replay()
    assert LAUNCHES["cc_lags"] == 2
    LAUNCHES.clear()


@pytest.fixture
def stand_in_cuda(monkeypatch):
    """graph.py's CUDA calls as CPU stand-ins."""
    install_stand_ins(monkeypatch.setattr)


def test_captured_chunk_and_step_replay_like_the_eager_loop(stand_in_cuda):
    """CapturedChunk and CapturedStep (warm-up, restore, capture, replays,
    the row-indexed metric stacks, the lr tensor) against the eager loop
    from one state and seed: the same metrics and parameters bit for bit,
    over two chunks of a generator re-seeded per chunk, then a step on a
    fixed batch at lr_scale 0.5; another generator is refused."""
    cfg = BiEARConfig(controller_mode="dual", deltaQ_mode="relative",
                      ctrl_dropout=0.1, backend_dropout=0.2, **SMALL)
    synth = _anechoic()
    hp = topt.TrainHyper()
    batch = synth.sample_batch(torch.Generator().manual_seed(3), 2)
    runs = []
    for captured in (False, True):
        model = ActiveBiEAR(cfg).init_weights_(1)
        opt = topt.make_optimizer(model, hp)
        step_fn = (lambda b, g, lr, model=model, opt=opt:
                   tloop.train_step(model, hp, opt, b, g, lr))
        state = tgraph.train_state(model, opt)
        if captured:
            chunk = tgraph.CapturedChunk(step_fn, synth.batch_fn(2), 3, state)
            step = tgraph.CapturedStep(step_fn, state)
        else:
            chunk = tloop.make_train_chunk(model, hp, opt, synth.batch_fn(2),
                                           3)
            step = tloop.make_train_step(model, hp, opt)
        gen = torch.Generator()
        ms = []
        for c in range(2):
            gen.manual_seed(100 + c)
            ms.append(chunk(gen))
        ms.append(step(batch, gen, 0.5))
        ms.append(step(batch, gen, torch.tensor(0.25)))
        runs.append((ms, _state(model, opt), gen.get_state()))
        if captured:
            assert chunk.graph.launches == collections.Counter()   # CPU
            with pytest.raises(ValueError, match="generator"):
                chunk(torch.Generator())
            with pytest.raises(ValueError, match="generator"):
                step(batch, torch.Generator())
    (m_e, s_e, g_e), (m_c, s_c, g_c) = runs
    assert torch.equal(g_e, g_c)
    for a, b in zip(s_e, s_c):
        assert torch.equal(a, b)
    for a, b in zip(m_e, m_c):
        assert list(a) == list(b)
        for k in a:
            assert a[k].shape == b[k].shape and torch.equal(a[k], b[k]), k
    assert m_c[0]["loss"].shape == (3,)


def test_captured_step_captures_anew_under_a_new_precision(stand_in_cuda):
    """The train step's key holds the MATMUL_PRECISION surface, as the
    forwards' does: a step under "bfloat16" after one under "default"
    captures a new graph; back under "default" the first graph replays."""
    cfg = BiEARConfig(controller_mode="dual", deltaQ_mode="relative", **SMALL)
    hp = topt.TrainHyper()
    batch = _anechoic().sample_batch(torch.Generator().manual_seed(3), 2)
    model = ActiveBiEAR(cfg).init_weights_(1)
    opt = topt.make_optimizer(model, hp)
    step = tgraph.CapturedStep(
        lambda b, g, lr: tloop.train_step(model, hp, opt, b, g, lr),
        tgraph.train_state(model, opt))
    gen = torch.Generator().manual_seed(0)
    for policy, graphs in (("default", 1), ("bfloat16", 2), ("default", 2)):
        with matmul_precision(policy):
            assert bool(torch.isfinite(step(batch, gen)["loss"]))
        assert len(step.graphs) == len(step.stats) == graphs
    assert {k[1][0] for k in step.graphs} == {"default", "bfloat16"}


def test_a_capture_runs_with_the_cyclic_collector_off(monkeypatch):
    """graph.Graph captures with Python's cyclic garbage collector off (a
    graph that it destroyed mid-capture would invalidate the capture) and
    turns it back on after, also when the capture raises."""
    import gc

    class StubGraph:
        def register_generator_state(self, gen):
            pass

    @contextlib.contextmanager
    def stub_capture(graph, pool=None, capture_error_mode="global"):
        yield

    for name, value in (("CUDAGraph", StubGraph), ("graph", stub_capture),
                        ("empty_cache", lambda: None),
                        ("memory_reserved", lambda *a: 0),
                        ("synchronize", lambda *a: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    seen, state = [], [torch.zeros(3)]

    def fn():
        seen.append(gc.isenabled())
        return {}

    def failing():
        seen.append(gc.isenabled())
        raise RuntimeError("capture failed")

    assert gc.isenabled()
    cgraph.Graph(fn, state, [])
    assert seen == [False] and gc.isenabled()
    with pytest.raises(RuntimeError, match="capture failed"):
        cgraph.Graph(failing, state, [])
    assert seen == [False, False] and gc.isenabled()
