"""The captured inference programs' contract, checked on the CPU.

On the card ``serve.infer.predict``, ``train.loop.make_eval_step`` /
``make_eval_chunk``, ``train.evaluate.eval_forward`` (and so
``collect_predictions``) and ``serve.streaming.stream_step`` replay CUDA
graphs (``biear_tpu_torch/graph.py``: ``Captured``, ``CapturedEvalChunk``);
without a card these tests hold what a capture needs and what the CPU can
show:

  * after one warm call, the function each graph captures makes no host
    sync and copies no host constant (tests/test_torch_port_capture.py's
    watcher), for the dual, single, fixed-Q and AuralNet models (predict,
    eval step, stream hop) and the passive one (eval step, eval forward);
  * with a stand-in for the CUDA graph that runs the captured function at
    each replay and writes its outputs into the capture's tensors (as a
    replay does), the captured paths give the eager paths' bits; the
    forward cache captures anew on a new shape, on a new MATMUL_PRECISION
    and on a new train / eval mode, and replays otherwise; a returned
    stream state (and any returned output) is unchanged by later calls; a
    parameter given new storage is refused; the eval chunk reads its
    stacks in place (no copy); every graph of a model's pool is reported;
  * ``capture=True`` on the CPU raises at every entry point;
  * the masked-fill ``stream_reset`` equals the per-leaf reset against a
    freshly built state bit for bit, and ``stream_init`` a fresh build.

The card's own checks: tests/test_torch_port_serve_capture_card.py and
``chip_smoke.py`` phase 19.
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

from biear_tpu_torch import graph as cgraph
from biear_tpu_torch.device import matmul_precision
from biear_tpu_torch.kernels import recording_launches
from biear_tpu_torch.models import (BiEARConfig, build_active,
                                    build_auralnet, build_passive)
from biear_tpu_torch.serve import infer as tinfer
from biear_tpu_torch.serve import streaming as tstream
from biear_tpu_torch.serve.profile_serve import AURALNET, GEOMETRY
from biear_tpu_torch.train import evaluate as tev
from biear_tpu_torch.train import loop as tloop
from biear_tpu_torch.train import optim as topt

from test_torch_port_capture import _NoStream, watching_host

SMALL = dict(n_bands=16, latent_dim=16, ctrl_hidden=16, timesteps=3)
# a streamable geometry (win == hop) at a small width
NARROW = dict(fs=1600, timesteps=4, n_fft=256, n_bands=24, fmin=50.0,
              fmax=700.0, latent_dim=16, ctrl_hidden=16)
FAMILIES = ["dual", "single", "fixed-q", "auralnet", "passive"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(family, **kw):
    """A seeded model of one family on the CPU, controllers perturbed so
    Q moves."""
    if family == "passive":
        return build_passive(BiEARConfig(**dict(SMALL, timesteps=5, **kw)),
                             device="cpu")
    if family == "auralnet":
        return build_auralnet(BiEARConfig(**dict(AURALNET, **SMALL,
                                                 d_model=32, **kw)),
                              device="cpu")
    mode = "single" if family == "single" else "dual"
    model = build_active(BiEARConfig(**GEOMETRY[mode], **dict(
        SMALL, fixed_frontend_q=family == "fixed-q", **kw)), seed=2,
        device="cpu")
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for ctrl in model.bifb.controllers():
            w = ctrl.q_out[8].weight
            w.copy_(0.25 * torch.randn(w.shape, generator=gen))
    return model


def _targets(rng, B):
    y = np.zeros((B, 8, 7), np.float32)
    y[:, :, 2] = 1.0
    for b in range(B):
        s = rng.integers(0, 8)
        y[b, s, :3] = (1.0, rng.uniform(), 0.0)
        y[b, s, 3 + rng.integers(0, 4)] = 1.0
    return y.reshape(B, 56)


def _batch(model, B=2, seed=0):
    """An eval batch of the model's family, as CPU tensors."""
    rng = np.random.default_rng(seed)
    cfg = model.cfg
    if isinstance(model, tev.PassiveBiEAR):
        tb = (B, cfg.timesteps, cfg.n_bands)
        fields = [rng.uniform(-80, 0, tb), rng.uniform(-80, 0, tb),
                  rng.uniform(-1, 1, (B, cfg.n_bands)),
                  rng.uniform(-np.pi, np.pi, tb),
                  rng.uniform(-np.pi, np.pi, tb)]
    else:
        fields = [rng.uniform(-1, 1, (B, cfg.fs)),
                  rng.uniform(-1, 1, (B, cfg.fs)),
                  rng.uniform(-1, 1, (B, cfg.n_bands))]
    fields.append(_targets(rng, B))
    return tuple(torch.tensor(a, dtype=torch.float32) for a in fields)


def _hops(model, B, n, seed=0):
    """n hops of (chunkL, chunkR) for `B` streams."""
    hop = tstream.stream_plan(model.cfg)["hop"]
    rng = np.random.default_rng(seed)
    return [tuple(torch.tensor(rng.uniform(-1, 1, (B, hop)),
                               dtype=torch.float32) for _ in range(2))
            for _ in range(n)]


def _leaves(tree):
    return tstream._leaves(tree)


def _same(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


# ---------------- no host sync, no host constant ----------------

def _captured_functions(family):
    """(label, fn) of each function a graph captures for the family, on
    fixed inputs: predict, the eval step, the eval forward and (active
    models) the stream hop on a flat state."""
    model = _model(family)
    hp = topt.TrainHyper()
    batch = _batch(model)
    model.eval()
    out = [("eval step",
            lambda: tloop.model_loss(model, hp, batch, None)[1]),
           ("eval forward",
            lambda: tev._eval_forward(model, *batch[:-1]))]
    if family != "passive":
        out.append(("predict",
                    lambda: tinfer._predict(model, batch[0], batch[1])))
    if family in ("dual", "single", "fixed-q"):
        smodel = _model(family, **NARROW)
        flat = tstream.stream_layout(smodel, 2).fresh.clone()
        chunks = _hops(smodel, 2, 1)[0]
        out.append(("stream hop",
                    lambda: tstream._hop(smodel, flat, *chunks)))
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_a_warm_inference_program_makes_no_host_sync_or_constant(
        family, monkeypatch):
    """What each captured graph runs (predict's whole composition, the
    eval step, the eval forward, one stream hop), after one warm call: no
    op that reads a device value on the host, no host array made a tensor
    (each would stall or break a capture on the card)."""
    for label, fn in _captured_functions(family):
        with torch.inference_mode():
            fn()
            with watching_host(monkeypatch) as (watch, calls):
                fn()
        assert watch.ops > 50, label           # it saw the program
        assert dict(watch.syncs) == {}, label
        assert dict(calls) == {}, label


def test_the_stream_readout_makes_no_host_constant(monkeypatch):
    model = _model("dual", **NARROW)
    state = tstream.stream_init(model, 2)
    for l, r in _hops(model, 2, 2):
        state = tstream.stream_step(model, state, l, r)
    tstream.stream_readout(model, state)
    with watching_host(monkeypatch) as (watch, calls):
        tstream.stream_readout(model, state)
    assert dict(watch.syncs) == {} and dict(calls) == {}


# ---------------- where the capture runs ----------------

def test_capture_on_the_cpu_raises_at_every_entry_point():
    model = _model("dual", **NARROW)
    hp = topt.TrainHyper()
    batch = _batch(model)
    with pytest.raises(ValueError, match="CUDA device"):
        tinfer.predict(model, batch[0], batch[1], capture=True)
    with pytest.raises(ValueError, match="CUDA device"):
        tev.eval_forward(model, batch[:3], capture=True)
    for make in (tloop.make_eval_step, tloop.make_eval_chunk):
        with pytest.raises(ValueError, match="CUDA device"):
            make(model, hp, capture=True)
    state = tstream.stream_init(model, 2)
    with pytest.raises(ValueError, match="CUDA device"):
        tstream.stream_step(model, state, *_hops(model, 2, 1)[0],
                            capture=True)
    assert "_captured_forwards" not in model.__dict__


# ---------------- the capture logic, with a stand-in graph ----------------

def _copy_tree(dst, src):
    for d, s in zip(_leaves(dst), _leaves(src)):
        d.copy_(s)


class _Replayer:
    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        new = self.fn()
        if new is not None:
            _copy_tree(self.out, new)


class _StandInGraph(cgraph.Graph):
    """Graph on the CPU: the 'capture' runs fn once (a real capture runs
    nothing: a chunk's row counter is zeroed before its replays anyway);
    each replay runs fn again and writes its output into the first run's
    tensors, as a replay overwrites the graph's static outputs. Replay,
    its storage check and launch counts are Graph's own."""

    captures = 0

    def __init__(self, fn, state, generators, pool=None):
        with recording_launches() as rec:
            self.out = fn()
        self.graph = _Replayer(fn, self.out)
        self.state, self.launches = state, rec
        self._ptrs = [t.data_ptr() for t in state]
        self.capture_ms, self.pool_bytes = 0.0, 0
        _StandInGraph.captures += 1


@pytest.fixture
def stand_in_capture(monkeypatch):
    """Every entry point takes its captured path on the CPU, with
    graph.py's CUDA calls as stand-ins (``capture=False`` stays eager)."""
    monkeypatch.setattr(cgraph, "Graph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _NoStream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: _NoStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    on = lambda model, mesh, capture: capture is not False and mesh is None
    for mod in (tinfer, tstream, tev, tloop):
        monkeypatch.setattr(mod, "use_capture", on)
    _StandInGraph.captures = 0


def _forwards(model):
    return model.__dict__["_captured_forwards"]


def test_predict_captures_per_shape_and_precision(stand_in_capture):
    """One graph per (shape, MATMUL_PRECISION surface): a repeated call
    replays, a new batch size or a new precision name captures anew (the
    ambient TF32 flags are part of the key too, so every call here is
    inside a named policy); every output
    equals the eager path's bits (on the CPU each name computes the same
    bits) and is a fresh tensor."""
    model = _model("dual")
    b2, b3 = _batch(model, 2, seed=1), _batch(model, 3, seed=2)
    with matmul_precision("default"):
        eager = tinfer.predict(model, b2[0], b2[1], capture=False)
        first = tinfer.predict(model, b2[0].numpy(), b2[1].numpy())
    held = [t.clone() for t in first]
    fwd = _forwards(model)["predict"]
    for wav, policy, graphs in ((b2, "default", 1), (b3, "default", 2),
                                (b2, "bfloat16", 3),
                                (b2, "tensorfloat32", 4), (b2, "bfloat16", 4),
                                (b3, "default", 4)):
        with matmul_precision(policy):
            got = tinfer.predict(model, wav[0], wav[1])
        want = tinfer.predict(model, wav[0], wav[1], capture=False)
        assert len(fwd.graphs) == _StandInGraph.captures == graphs
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert not any(g.data_ptr() == o.data_ptr()
                       for g in got for o in _leaves(
                           tuple(v[2].out for v in fwd.graphs.values())))
    assert all(torch.equal(a, b) for a, b in zip(first, eager))
    assert all(torch.equal(a, b) for a, b in zip(first, held))
    assert {k[1][0] for k in fwd.graphs} == {"default", "bfloat16",
                                             "tensorfloat32"}
    assert set(fwd.stats) == set(fwd.graphs)


def test_new_parameter_storage_is_refused(stand_in_capture):
    model = _model("single")
    b = _batch(model)
    tinfer.predict(model, b[0], b[1])
    p = next(model.parameters())
    kept = p.data
    p.data = kept.clone()
    with pytest.raises(RuntimeError, match="new storage"):
        tinfer.predict(model, b[0], b[1])
    p.data = kept
    tinfer.predict(model, b[0], b[1])
    with torch.no_grad():                   # in place: read by the replay
        p.add_(1.0)
    got = tinfer.predict(model, b[0], b[1])
    want = tinfer.predict(model, b[0], b[1], capture=False)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("family", ["dual", "auralnet", "passive"])
def test_captured_eval_step_chunk_and_forward_equal_eager(family,
                                                          stand_in_capture):
    """The eval step, the eval chunk (two different stacks of one shape,
    each with its own graph, which a second call replays) and the eval
    forward / collect_predictions, captured against eager, bit for
    bit."""
    model = _model(family)
    hp = topt.TrainHyper()
    batches = [_batch(model, 2, seed=s) for s in range(6)]
    step = tloop.make_eval_step(model, hp)
    eager_step = tloop.make_eval_step(model, hp, capture=False)
    for b in batches[:2]:
        got, want = step(b), eager_step(b)
        assert all(torch.equal(got[k], want[k]) for k in want)
    chunk = tloop.make_eval_chunk(model, hp)
    eager_chunk = tloop.make_eval_chunk(model, hp, capture=False)
    parts = [tuple(torch.stack(f) for f in zip(*part))
             for part in (batches[:3], batches[3:])]
    for stacks in parts + parts:
        got, want = chunk(stacks), eager_chunk(stacks)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert _StandInGraph.captures == 3   # the step; the chunk, one per stack
    x = batches[0][:-1]
    got = tev.eval_forward(model, [f.numpy() for f in x])
    want = tev.eval_forward(model, x, capture=False)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _captured(model, name):
    (c,) = [c for c in model.__dict__["_graphs"] if c.name == name]
    return c


def test_the_eval_chunk_reads_its_stacks_in_place(stand_in_capture):
    """The eval chunk's graph reads the caller's stacks (kept by the
    graph, which copies nothing in), so a split is held once: a change
    made to the stacks in place is what the next replay evaluates; stacks
    off the model's device are refused."""
    model = _model("dual")
    hp = topt.TrainHyper()
    stacks = tuple(torch.stack(f) for f in zip(
        *[_batch(model, 2, seed=s) for s in range(3)]))
    chunk = tloop.make_eval_chunk(model, hp)
    eager_chunk = tloop.make_eval_chunk(model, hp, capture=False)
    chunk(stacks)
    ((static, _, _, _),) = _captured(model, "eval_chunk").graphs.values()
    assert all(a is b for a, b in zip(static, stacks))
    with torch.no_grad():
        stacks[0].mul_(0.5)
    got, want = chunk(stacks), eager_chunk(stacks)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert _StandInGraph.captures == 1
    with pytest.raises(ValueError, match="in place"):
        chunk(tuple(torch.empty_like(s, device="meta") for s in stacks))


def test_a_forward_captures_anew_when_the_mode_changes(stand_in_capture):
    """The training flag is part of a forward's key: after ``.train()`` a
    captured ``predict`` or eval forward does what the eager one does (it
    raises: training mode needs a dropout generator) instead of replaying
    the eval-mode graph; back in eval mode the first graph replays."""
    model = _model("dual")
    b = _batch(model)
    tinfer.predict(model, b[0], b[1])
    tev.eval_forward(model, b[:3])
    model.train()
    for call in (lambda **kw: tinfer.predict(model, b[0], b[1], **kw),
                 lambda **kw: tev.eval_forward(model, b[:3], **kw)):
        for capture in (False, None):
            with pytest.raises(ValueError, match="Generator"):
                call(capture=capture)
    model.eval()
    got = tinfer.predict(model, b[0], b[1])
    want = tinfer.predict(model, b[0], b[1], capture=False)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _StandInGraph.captures == 2
    assert [k[2] for k in _forwards(model)["predict"].graphs] == [False]


def test_pool_stats_reports_every_graph_of_the_pool(stand_in_capture):
    """``pool_stats`` lists the graphs of the model's shared pool: the
    cached forwards and the live eval step and eval chunk."""
    model = _model("dual")
    hp = topt.TrainHyper()
    b = _batch(model)
    step, chunk = tloop.make_eval_step(model, hp), tloop.make_eval_chunk(
        model, hp)
    step(b)
    chunk(tuple(x[None] for x in b))
    tinfer.predict(model, b[0], b[1])
    tev.eval_forward(model, b[:3])
    stats = cgraph.pool_stats(model)
    assert set(stats) == {"eval_step", "eval_chunk", "predict",
                          "eval_forward", "pool_bytes"}
    assert all(len(stats[k]) == 1 for k in stats if k != "pool_bytes")
    assert stats["pool_bytes"] == 0          # the stand-in reserves none
    del step, chunk
    gc.collect()
    assert set(cgraph.pool_stats(model)) == {"predict", "eval_forward",
                                             "pool_bytes"}


class _Rows:
    def __init__(self, arrays):
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays[0])

    def rows(self, idx):
        return tuple(a[idx] for a in self.arrays)


def test_collect_predictions_captured_equals_eager(stand_in_capture):
    """5 rows at batch 2: the last batch padded to full, so one graph."""
    model = _model("dual")
    ds = _Rows([f.numpy() for f in _batch(model, 5, seed=3)])
    got = tev.collect_predictions(model, ds, 2)
    want = tev.collect_predictions(model, ds, 2, capture=False)
    assert _StandInGraph.captures == 1
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert got[0].shape == (5, 8)


@pytest.mark.parametrize("family", ["dual", "single", "fixed-q"])
def test_a_held_stream_state_is_unchanged_by_later_hops(family,
                                                        stand_in_capture):
    """Captured hops against eager ones from one state, state by state bit
    for bit; every state returned earlier (and the fresh one) is left as
    it was after later hops; the readout equals the eager one; churn
    through the masked reset; one graph per batch."""
    model = _model(family, **NARROW)
    B = 3
    hops = _hops(model, B, model.cfg.timesteps + 2, seed=1)
    cap = eag = tstream.stream_init(model, B)
    held = []
    mask = torch.tensor([True, False, True])
    for i, (l, r) in enumerate(hops):
        if i == 2:
            cap = tstream.stream_reset(model, cap, mask)
            eag = tstream.stream_reset(model, eag, mask)
        cap = tstream.stream_step(model, cap, l, r)
        eag = tstream.stream_step(model, eag, l, r, capture=False)
        assert _same(cap, eag), i
        held.append((cap, [t.clone() for t in _leaves(cap)]))
    for state, snap in held:
        assert all(torch.equal(a, b) for a, b in zip(_leaves(state), snap))
    assert _same(tstream.stream_init(model, B),
                 tstream._fresh_state(model, B))
    got = tstream.stream_readout(model, cap)
    want = tstream.stream_readout(model, eag)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _StandInGraph.captures == 1
    tstream.stream_step(model, tstream.stream_init(model, 2),
                        *_hops(model, 2, 1)[0])
    assert _StandInGraph.captures == 2


# ---------------- the masked reset ----------------

def _reset_per_leaf(model, state, mask):
    """The per-leaf reset against a freshly built state: the reset
    before the masked fill."""
    B = mask.shape[0]
    fresh = tstream._fresh_state(model, B)

    def sel(axis, s0, s):
        m = mask.reshape((1,) * axis + (B,) + (1,) * (s.ndim - axis - 1))
        return torch.where(m, s0, s)

    out = {}
    for k in state:
        axis = model.bifb.STREAM_AXIS if k == "fe" else 0
        leaves = [sel(axis, a, b) for a, b in zip(_leaves(fresh[k]),
                                                  _leaves(state[k]))]
        out[k] = tstream._rebuild(state[k], iter(leaves))
    return out


@pytest.mark.parametrize("family", ["dual", "single", "fixed-q"])
def test_the_masked_reset_equals_the_per_leaf_reset(family):
    model = _model(family, **NARROW)
    B = 5
    state = tstream.stream_init(model, B)
    for l, r in _hops(model, B, 3, seed=2):
        state = tstream.stream_step(model, state, l, r)
    for mask in (torch.tensor([True, False, False, True, True]),
                 np.zeros(B, bool), np.ones(B, bool)):
        got = tstream.stream_reset(model, state, mask)
        want = _reset_per_leaf(model, state,
                               torch.as_tensor(mask).bool())
        assert _same(got, want)
        fresh = tstream._fresh_state(model, B)
        m = torch.as_tensor(mask).bool()
        for k in got:
            axis = model.bifb.STREAM_AXIS if k == "fe" else 0
            for g, f, s in zip(_leaves(got[k]), _leaves(fresh[k]),
                               _leaves(state[k])):
                idx = torch.arange(B)
                assert torch.equal(g.index_select(axis, idx[m]),
                                   f.index_select(axis, idx[m]))
                assert torch.equal(g.index_select(axis, idx[~m]),
                                   s.index_select(axis, idx[~m]))
