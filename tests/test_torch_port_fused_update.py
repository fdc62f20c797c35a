"""The optimizer step and its telemetry on the CPU: the plain version (the
contract) and the wrapper of ``kernels/fused_update.cu``.

The plain version (``loop.plain_update``: ``group_norms``,
``grad_histograms``, ``optim.Adam``) is held to a float64 numpy reference
of the masked, clipped Adam step, and its histogram's edge cases to the
definition and to the JAX package's ``_grad_histograms``. The wrapper
(``fused_update.run_update``) runs here against ``_fused_update_cases.
Kernels``, the kernels' C interface emulated in numpy over host memory:
its leaf tables, scratch offsets, launches and outputs are held to the
plain version at the card tests' limits. The kernels themselves are held
on the card by ``tests/test_torch_port_fused_update_card.py``.
"""

import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from biear_tpu.train import loop as jloop

import _fused_update_cases as cases
from biear_tpu_torch.kernels import LAUNCHES
from biear_tpu_torch.train import fused_update as fu
from biear_tpu_torch.train import loop as tloop
from biear_tpu_torch.train.optim import B1, B2, is_frontend

EDGES = tloop.GRAD_HIST_EDGES
MAX_LOG = 200
TRAINING = ("dual", "fixed_q", "freeze", "passive")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """An update here is thousands of small CPU ops: on one thread each,
    none waits on the intra-op pool, whose hand-offs cost far more than
    the ops when the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _names(model) -> list:
    return [n for n, _ in model.named_parameters()]


def _plain(model, opt, grads, loss, lr_scale=1.0, max_log=MAX_LOG):
    return tloop.plain_update(model, opt, dict(zip(_names(model), grads)),
                              loss, lr_scale, max_log)


def _fused(model, opt, grads, loss, lr_scale=1.0, max_log=MAX_LOG,
           kernels=None):
    return fu.run_update(kernels or cases.Kernels(), 0, model, opt, grads,
                         loss, lr_scale, max_log)


def _buckets(g: np.ndarray) -> np.ndarray:
    """(18,) counts of the number of edges strictly below |g|."""
    k = (np.abs(g.reshape(-1))[:, None] > EDGES[None, :]).sum(1)
    return np.bincount(k, minlength=len(EDGES) + 1).astype(np.float32)


def _numpy_update(model, opt, grads, loss: float, lr_scale: float, hp):
    """The contract in numpy: (norms, skipped, histogram rows, parameters
    after, each trained group's moments and count after). The norms in
    float64; the update in float32 with torch's float32 constants (B1,
    B2, 1 - B1 and 1 - B2 rounded once, the bias corrections 1 -
    B**count in float32), as the plain version and the kernel compute
    it."""
    f32 = np.float32
    names = _names(model)
    g32 = {n: g.numpy() for n, g in zip(names, grads)}
    norms, flags = {}, []
    for label, front in (("fb", True), ("backend", False)):
        leaves = [g32[n].astype(np.float64) for n in names
                  if is_frontend(n) == front]
        norms[f"grad_{label}_norm"] = math.sqrt(sum(float((g ** 2).sum())
                                                    for g in leaves))
        norms[f"grad_{label}_absmax"] = max(
            (float(np.abs(g).max()) for g in leaves), default=0.0)
        flags.append(all(np.isfinite(g).all() for g in leaves))
        norms[f"grad_{label}_finite"] = float(flags[-1])
    ok = math.isfinite(loss) and all(flags)
    hist = np.stack([_buckets(g32[n]) for n in names[:MAX_LOG]])
    params = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    state = []
    for g in opt.groups:
        if g.frozen or not g.params:
            continue
        norm = f32(norms["grad_fb_norm" if g.label == "frontend"
                         else "grad_backend_norm"])
        factor = f32(1.0) if norm < f32(g.clip) else f32(g.clip) / norm
        count = int(g.count) + 1
        bc1 = f32(1.0) - f32(B1) ** f32(count)
        bc2 = f32(1.0) - f32(B2) ** f32(count)
        for n, m, v in zip(g.names, g.m, g.v):
            u = g32[n] * factor + f32(hp.weight_decay) * params[n]
            m1 = m.numpy() * f32(B1) + f32(1.0 - B1) * u
            v1 = v.numpy() * f32(B2) + f32(1.0 - B2) * (u * u)
            den = np.sqrt(v1 / bc2) + f32(hp.adam_eps)
            step = (m1 / bc1) / den * f32(-g.lr) * f32(lr_scale)
            if ok:
                params[n] = params[n] + step
                state.append((m1, v1))
            else:
                state.append((m.numpy().copy(), v.numpy().copy()))
        state.append(count if ok else count - 1)
    return norms, 0.0 if ok else 1.0, hist, params, state


@pytest.mark.parametrize("family", TRAINING)
def test_plain_update_matches_a_float64_adam(family):
    """Two steps of the plain update against the float64 contract: norms,
    absolute maxima and flags, the histogram exactly, every parameter and
    moment, the counts; a frozen group's parameters keep their bits."""
    model, opt, hp = cases.build(family)
    frozen = [p.detach().clone() for g in opt.groups if g.frozen
              for p in g.params]
    for step in range(2):
        grads = cases.gradients(model, 10 + step, cases.WIDE)
        p0 = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
        m0 = [x for g in opt.groups if not g.frozen for x in
              [*((m.numpy().copy(), v.numpy().copy())
                 for m, v in zip(g.m, g.v)), int(g.count)]]
        want = _numpy_update(model, opt, grads, 0.5, 0.75, hp)
        norms, skipped, hist = _plain(model, opt, grads, torch.tensor(0.5),
                                      0.75)
        for k, v in want[0].items():
            assert math.isclose(float(norms[k]), v, rel_tol=1e-6), k
        assert float(skipped) == want[1] == 0.0
        np.testing.assert_array_equal(hist.numpy(), want[2])
        for n, p in model.named_parameters():
            assert cases.state_close(p.detach(), want[3][n], p0[n]), n
        live = [g for g in opt.groups if not g.frozen]
        got = [x for g in live for x in
               [*((m.numpy(), v.numpy()) for m, v in zip(g.m, g.v)),
                int(g.count)]]
        for a, b, b0 in zip(got, want[4], m0):
            if isinstance(b, int):
                assert a == b == step + 1
            else:
                assert cases.state_close(a[0], b[0], b0[0])
                assert cases.state_close(a[1], b[1], b0[1])
    for a, g in zip(frozen, (p for g in opt.groups if g.frozen
                             for p in g.params)):
        assert torch.equal(a, g)


@pytest.mark.parametrize("family", [*TRAINING, "auralnet"])
def test_fused_wrapper_matches_the_plain_update(family):
    """Three steps through run_update on the emulated kernels against the
    plain update from the same state: three launches a step, counted; the
    outputs and states at the card tests' limits, both sides starting
    each step from the same state. The third step's gradients span 18
    decades (every bucket); its plain twin is clipped by the fused norms
    (``cases.plain_given_norms``)."""
    model, opt, _ = cases.build(family)
    twin = copy.deepcopy((model, opt))
    for step, decades in enumerate((cases.USUAL, cases.USUAL, cases.WIDE)):
        grads = cases.gradients(model, 20 + step, decades)
        before = cases.state_of(model, opt)
        kernels = cases.Kernels()
        n0 = LAUNCHES["fused_update"]
        got = _fused(model, opt, grads, torch.tensor(1.0), kernels=kernels)
        assert kernels.calls == ["stats", "finalize3", "adam"]
        assert LAUNCHES["fused_update"] - n0 == 3
        if decades == cases.WIDE:
            want = cases.plain_given_norms(*twin, grads, torch.tensor(1.0),
                                           1.0, MAX_LOG, got[0])
        else:
            want = _plain(*twin, grads, torch.tensor(1.0))
        cases.compare_updates(got, want, before, cases.state_of(model, opt),
                              cases.state_of(*twin))
        cases.sync(twin, (model, opt))


def _edge_case(case: str) -> np.ndarray:
    e = EDGES.astype(np.float32)
    tiny = np.finfo(np.float32).smallest_subnormal
    return {
        "on_edges": np.concatenate([e, -e]),
        "above_edges": np.nextafter(e, np.float32(np.inf)),
        "zeros": np.array([0.0, -0.0, 0.0, 1.0], np.float32),
        "nan": np.array([np.nan, 1.0, -np.nan, 0.0], np.float32),
        "inf": np.array([np.inf, -np.inf, 3.0, 1e30], np.float32),
        "subnormal": np.array([tiny, -tiny, 1e-39, -1e-40, 1e-12],
                              np.float32),
    }[case].astype(np.float32)


EDGE_CASES = ("on_edges", "above_edges", "zeros", "nan", "inf", "subnormal")


@pytest.mark.parametrize("case", EDGE_CASES)
def test_histogram_edge_cases(case):
    """|g| exactly on each edge (bucket k: k edges strictly below), just
    above each, zeros, NaN (bucket 0), +-inf (bucket 17) and subnormals:
    the plain row, the JAX package's and the wrapper's on the emulated
    kernels all equal the definition; a nonfinite leaf skips the step
    and leaves the state to the bit, both ways."""
    vals = _edge_case(case)
    want = _buckets(vals)
    if case == "on_edges":
        assert list(want) == [2.0] * 17 + [0.0]
    if case in ("nan", "inf"):
        assert want[0 if case == "nan" else -1] == 3.0
    np.testing.assert_array_equal(tloop._hist_row(torch.tensor(vals)).numpy(),
                                  want)
    np.testing.assert_array_equal(
        np.asarray(jloop._grad_histograms([jnp.asarray(vals)], 1))[0], want)

    model, opt, _ = cases.build("fixed_q")
    grads = [torch.zeros_like(p) for p in model.parameters()]
    leaf = next(i for i, p in enumerate(model.parameters())
                if p.numel() >= vals.size)
    grads[leaf].view(-1)[:vals.size] = torch.tensor(vals)
    twin = copy.deepcopy((model, opt))
    before = cases.state_of(model, opt)
    got = _fused(model, opt, grads, torch.tensor(1.0))
    plain = _plain(*twin, grads, torch.tensor(1.0))
    row = want.copy()
    row[0] += grads[leaf].numel() - vals.size
    np.testing.assert_array_equal(got[2][leaf].numpy(), row)
    finite = bool(np.isfinite(vals).all())
    assert float(got[1]) == float(plain[1]) == (0.0 if finite else 1.0)
    if finite:
        cases.compare_updates(got, plain, before, cases.state_of(model, opt),
                              cases.state_of(*twin))
    else:
        for side in ((model, opt), twin):
            assert all(cases.bits_equal(a, b) for a, b in
                       zip(before, cases.state_of(*side)))
        assert cases.bits_equal(got[2], plain[2])
        for k in plain[0]:
            assert cases.bits_equal(got[0][k], plain[0][k]), k


@pytest.mark.parametrize("path", ["plain", "fused"])
def test_lr_scale_as_a_float_and_as_a_tensor(path):
    """lr_scale 0.5 as a float and as a 0-dim tensor give the same bits;
    0.0 leaves every parameter's bits and still moves the moments."""
    run = _plain if path == "plain" else _fused
    model, opt, _ = cases.build("dual")
    grads = cases.gradients(model, 3)
    ends = []
    for scale in (0.5, torch.tensor(0.5)):
        m, o = copy.deepcopy((model, opt))
        run(m, o, grads, torch.tensor(1.0), scale)
        ends.append(cases.state_of(m, o))
    assert all(cases.bits_equal(a, b) for a, b in zip(*ends))
    before = cases.state_of(model, opt)
    run(model, opt, grads, torch.tensor(1.0), torch.tensor(0.0))
    after = cases.state_of(model, opt)
    n = len(list(model.parameters()))
    assert all(cases.bits_equal(a, b) for a, b in zip(before[:n], after[:n]))
    assert not all(cases.bits_equal(a, b)
                   for a, b in zip(before[n:], after[n:]))


@pytest.mark.parametrize("path", ["plain", "fused"])
@pytest.mark.parametrize("poison", ["nan_gradient", "inf_loss"])
def test_a_nonfinite_step_leaves_the_state(path, poison):
    """A NaN in one gradient leaf or an infinite loss: skipped is 1 and
    the parameters, moments and counts keep their bits."""
    run = _plain if path == "plain" else _fused
    model, opt, _ = cases.build("dual")
    run(model, opt, cases.gradients(model, 4), torch.tensor(1.0))
    grads = cases.gradients(model, 5)
    loss = torch.tensor(1.0)
    if poison == "nan_gradient":
        grads[7].view(-1)[1] = float("nan")
    else:
        loss = torch.tensor(float("inf"))
    before = cases.state_of(model, opt)
    _, skipped, _ = run(model, opt, grads, loss)
    assert float(skipped) == 1.0
    assert all(cases.bits_equal(a, b)
               for a, b in zip(before, cases.state_of(model, opt)))


@dataclasses.dataclass
class _Mesh:
    """A model group of one rank, as rank `model_rank` sees it: the
    collectives leave their tensors and log their sizes."""
    model_rank: int
    calls: list = dataclasses.field(default_factory=list)

    def model_sum_(self, t):
        self.calls.append(("sum", t.numel()))
        return t

    def model_max_(self, t):
        self.calls.append(("max", t.numel()))
        return t


def test_under_a_model_axis_the_table_goes_through_the_mesh():
    """With a layout (rows: the whole model's tensors, one that this rank
    does not hold; replicated leaves not counted on model rank 1) the
    wrapper launches stats, finalize phase A, the mesh's max and sum over
    the table, phase B and adam, and equals the plain layout path."""
    from biear_tpu_torch.parallel.mesh import ShardLayout, Split

    model, opt, _ = cases.build("dual")
    names = _names(model)
    entries = {"held.elsewhere": ((3,), Split(0))}
    entries.update({n: (tuple(p.shape), Split(0) if i % 3 == 0 else None)
                    for i, (n, p) in enumerate(model.named_parameters())})
    mesh = _Mesh(model_rank=1)
    model.shard_layout = ShardLayout(mesh, entries)
    twin = copy.deepcopy((model, opt))
    grads = cases.gradients(model, 6)
    before = cases.state_of(model, opt)
    kernels = cases.Kernels()
    got = _fused(model, opt, grads, torch.tensor(1.0), kernels=kernels)
    assert kernels.calls == ["stats", "finalize1", "finalize2", "adam"]
    E = len(entries)
    assert mesh.calls == [("max", 2 * E), ("sum", 22 * E)]
    want = _plain(*twin, grads, torch.tensor(1.0))
    assert got[2].shape == (min(E, MAX_LOG), 18)
    assert float(got[2][0].sum()) == 0.0       # the row it does not hold
    assert float(got[2][2].sum()) == 0.0       # replicated, not counted
    assert float(got[2][1].sum()) == grads[0].numel()
    cases.compare_updates(got, want, before, cases.state_of(model, opt),
                          cases.state_of(*twin))
    assert names == _names(twin[0])


def test_leaf_tables_split_past_max_leaves(monkeypatch):
    """More leaves than a table holds: one stats and one adam launch per
    table, the same results."""
    monkeypatch.setattr(fu, "MAX_LEAVES", 50)
    model, opt, _ = cases.build("dual")
    twin = copy.deepcopy((model, opt))
    grads = cases.gradients(model, 7)
    before = cases.state_of(model, opt)
    kernels = cases.Kernels()
    got = _fused(model, opt, grads, torch.tensor(1.0), kernels=kernels)
    tables = -(-len(grads) // 50)
    assert kernels.calls == ["stats"] * tables + ["finalize3"] + [
        "adam"] * tables
    want = _plain(*twin, grads, torch.tensor(1.0))
    cases.compare_updates(got, want, before, cases.state_of(model, opt),
                          cases.state_of(*twin))


def test_plans_are_kept_per_set_of_addresses():
    """The same gradients reuse their packed tables; new addresses pack
    new ones; at most PLANS_KEPT are kept per optimizer."""
    model, opt, _ = cases.build("fixed_q")
    grads = cases.gradients(model, 8)
    args = (model, opt, grads, MAX_LOG, None)
    first = fu.plan_of(*args)
    assert fu.plan_of(*args) is first
    for seed in range(fu.PLANS_KEPT + 2):
        fu.plan_of(model, opt, cases.gradients(model, seed), MAX_LOG, None)
    assert len(fu._plans[opt]) == fu.PLANS_KEPT
    assert fu.plan_of(*args) is not first
    assert first.n_leaves == len(grads) and first.n_groups == 1
    assert first.n_hist == min(len(grads), MAX_LOG)


def test_a_group_that_is_not_one_telemetry_group_is_refused():
    model, opt, _ = cases.build("dual")
    front, back = opt.groups
    back.names.append(front.names.pop())
    back.params.append(front.params.pop())
    with pytest.raises(ValueError, match="frontend leaves"):
        _fused(model, opt, cases.gradients(model, 9), torch.tensor(1.0))


def test_cpu_gradients_take_the_plain_update():
    """apply_update on CPU tensors launches nothing; fused_update refuses
    gradients that are not on a card."""
    model, opt, _ = cases.build("fixed_q")
    grads = cases.gradients(model, 11)
    n0 = sum(LAUNCHES.values())
    m = tloop.apply_update(model, opt, grads, {"loss": torch.tensor(1.0)},
                           torch.tensor(8.0), 1.0, MAX_LOG)
    assert sum(LAUNCHES.values()) == n0
    assert list(m) == ["loss", *fu.NORM_KEYS, "skipped", "weight",
                       "grad_hist"]
    with pytest.raises(ValueError, match="not a card"):
        fu.fused_update(model, opt, grads, torch.tensor(1.0), 1.0, MAX_LOG)
