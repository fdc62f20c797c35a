"""Shared cases of the optimizer-update tests: the model families, seeded
gradients, clones of a model's training state, the comparison of two
updates, and ``Kernels``, the C interface of ``kernels/fused_update.cu``
emulated in numpy over host memory.

Imports no JAX: ``tests/test_torch_port_fused_update_card.py`` runs on a
machine without it.
"""

import ctypes

import numpy as np
import torch

from biear_tpu_torch.models import (ActiveBiEAR, AuralNet, BiEARConfig,
                                    PassiveBiEAR)
from biear_tpu_torch.parallel.mesh import layout_of
from biear_tpu_torch.train import fused_update as fu
from biear_tpu_torch.train import loop as tloop
from biear_tpu_torch.train.optim import TrainHyper, make_optimizer

TINY = dict(fs=1600, timesteps=4, n_fft=256, n_bands=24, fmin=50.0,
            fmax=700.0, latent_dim=24)
FLAGSHIP = dict(controller_mode="dual", deltaQ_mode="relative",
                deltaQ_base=1.0, deltaQ_low_factor=0.3, deltaQ_high_factor=5.0)
# label -> (model class, config keywords, make_optimizer keywords): the
# flagship's two groups, fixed Q's one group over every leaf, a frozen
# frontend, the passive family (no frontend) and AuralNet (fixed Q,
# attention; serve.profile_serve.AURALNET)
FAMILIES = {
    "dual": (ActiveBiEAR, FLAGSHIP, {}),
    "fixed_q": (ActiveBiEAR, dict(FLAGSHIP, fixed_frontend_q=True), {}),
    "freeze": (ActiveBiEAR, FLAGSHIP, dict(freeze_controller=True)),
    "passive": (PassiveBiEAR, {}, {}),
    "auralnet": (AuralNet, dict(fixed_frontend_q=True,
                                controller_mode="dual",
                                deltaQ_mode="absolute", deltaQ_base=2.0,
                                deltaQ_low_factor=0.5,
                                deltaQ_high_factor=1.0), {}),
}
STATE_RTOL = 1e-5      # a leaf's change of p, m or v, relative to its norm
NORM_RTOL = 2e-6


def build(family: str, device="cpu", tiny: bool = True, seed: int = 0):
    """(model, optimizer, hyper-parameters) of `family`, seeded."""
    cls, kw, opt_kw = FAMILIES[family]
    cfg = BiEARConfig(**{**(TINY if tiny else {}), **kw})
    model = cls(cfg).init_weights_(seed).to(device)
    hp = TrainHyper()
    return model, make_optimizer(model, hp, **opt_kw), hp


WIDE = (-13.0, 5.0)     # every histogram bucket
USUAL = (-5.0, -1.0)    # a trained model's gradients


def gradients(model, seed: int, decades: tuple = USUAL,
              zeros: int = 3) -> list:
    """One float32 gradient per parameter: normal values times 10 to a
    uniform power in `decades`, the first `zeros` entries of each leaf
    zero."""
    rng = np.random.default_rng(seed)
    out = []
    for p in model.parameters():
        g = (rng.standard_normal(p.shape)
             * 10.0 ** rng.uniform(*decades, p.shape)).astype(np.float32)
        g.reshape(-1)[:zeros] = 0.0
        out.append(torch.as_tensor(g, device=p.device))
    return out


def state_of(model, optimizer) -> list:
    """``state_tensors``, cloned."""
    return [t.clone() for t in state_tensors(model, optimizer)]


@torch.no_grad()
def sync(dst: tuple, src: tuple) -> None:
    """Copy the training state of (model, optimizer) `src` into `dst`, so
    a comparison's next step starts both sides from the same bits."""
    for a, b in zip(state_tensors(*dst), state_tensors(*src)):
        a.copy_(b)


def state_tensors(model, optimizer) -> list:
    """Every tensor an update writes: parameters, then each trained
    group's moments and count."""
    out = [p.detach() for p in model.parameters()]
    for g in optimizer.groups:
        if not g.frozen and g.params:
            out += [*g.m, *g.v, g.count]
    return out


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the bit, where a NaN equals any NaN (a reduction's NaN
    payload is its library's choice)."""
    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a, b = a.masked_fill(nan, 0.0), b.masked_fill(nan, 0.0)
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def plain_given_norms(model, optimizer, grads: list, loss, lr_scale,
                      max_log: int, norms: dict) -> tuple:
    """``loop.plain_update`` with the optimizer's clip norms given (the
    fused update's `norms`), as its model-axis path gives them: the
    telemetry as the plain version computes it. Where gradients span
    many decades, a norm that differs in its last bits moves u = g *
    factor + wd * p far in relative terms wherever the two terms cancel;
    with the same norm the two updates differ only in rounding."""
    named = dict(zip((n for n, _ in model.named_parameters()), grads))
    layout = layout_of(model)
    own = tloop.group_norms(named, layout)
    ok = (torch.isfinite(loss) & (own["grad_fb_finite"] > 0)
          & (own["grad_backend_finite"] > 0))
    optimizer.step(named, ok, lr_scale, norms={
        "frontend": norms["grad_fb_norm"],
        "backend": norms["grad_backend_norm"]})
    return own, 1.0 - ok.float(), tloop.grad_histograms(named, max_log,
                                                          layout)


def state_close(got, want, before, rtol: float = STATE_RTOL) -> bool:
    """A leaf's change `got` - `before` within `rtol` of `want` - `before`
    (norms over the leaf), give or take two float32 spacings of each
    stored value: the two sides round a parameter to float32 after
    steps that may differ in their last bits."""
    g, w, b = (np.asarray(x, np.float64) for x in (got, want, before))
    floor = 2 * np.linalg.norm(np.spacing(np.abs(w).astype(np.float32)))
    return bool(np.linalg.norm(g - w) <= rtol * np.linalg.norm(w - b)
                + floor)


def compare_updates(got: tuple, want: tuple, before: list, after_got: list,
                    after_want: list) -> None:
    """The fused update `got` against the plain `want` (norms, skipped,
    grad_hist) and their states after, from the same state `before`:
    histogram, flags, absolute maxima and skipped to the bit, norms to
    NORM_RTOL, each state tensor by ``state_close``, the counts equal."""
    (gn, gs, gh), (wn, ws, wh) = got, want
    assert list(gn) == list(wn)
    for k in gn:
        if k.endswith("_norm"):
            torch.testing.assert_close(gn[k], wn[k], rtol=NORM_RTOL, atol=0,
                                       msg=k)
        else:
            assert bits_equal(gn[k], wn[k]), (k, gn[k], wn[k])
    assert bits_equal(gs, ws), (gs, ws)
    assert bits_equal(gh, wh)
    for i, (b, g, w) in enumerate(zip(before, after_got, after_want)):
        if b.dtype == torch.int32:
            assert torch.equal(g, w), i
        else:
            assert state_close(g.cpu(), w.cpu(), b.cpu()), i


# ---------------- fused_update.cu's C interface, emulated ----------------

def _f32(addr: int, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros(0, np.float32)
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(addr))


def _i32(addr: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_int32 * n).from_address(addr))


def _arr(a) -> list:
    return [0 if x is None else x for x in a]


class Kernels:
    """The three launches of fused_update.cu in numpy, on the addresses the
    wrapper passes (host memory: CPU tensors). ``calls`` lists them."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def fused_update_table_bytes() -> int:
        return 16 + 16 * fu.MAX_LEAVES + 32 * fu.MAX_LEAVES

    @staticmethod
    def table(buf) -> tuple:
        ml, raw = fu.MAX_LEAVES, buf.raw
        k, leaf0, tile0, n_tiles = (int(x) for x in
                                    np.frombuffer(raw, np.int32, 4))
        ints = np.frombuffer(raw, np.int32, 4 * ml, 16).reshape(4, ml)
        addr = np.frombuffer(raw, np.uint64, 4 * ml, 16 + 16 * ml)
        starts = [int(x) for x in ints[0, :k]] + [n_tiles]
        return (k, leaf0, tile0, starts, ints[1, :k], ints[2, :k],
                ints[3, :k], addr.reshape(4, ml)[:, :k])

    def fused_update_stats_launch(self, buf, edges, partials, linfo, stream):
        self.calls.append("stats")
        k, leaf0, tile0, starts, n, row, meta, addr = self.table(buf)
        e = np.array(edges[:], np.float32)
        for l in range(k):
            g = _f32(int(addr[0, l]), int(n[l]))
            for b in range(starts[l], starts[l + 1]):
                x = g[(b - starts[l]) * fu.TILE:(b - starts[l] + 1) * fu.TILE]
                a = np.abs(x)
                r = _f32(partials + 4 * (tile0 + b) * fu.PARTIAL, fu.PARTIAL)
                with np.errstate(over="ignore"):
                    r[0] = np.sum(a * a, dtype=np.float32)
                r[1] = a.max() if a.size else 0.0
                u = r.view(np.uint32)
                u[2] = int((~np.isfinite(x)).sum())
                u[3] = x.size
                u[4:] = (a[None, :] > e[:, None]).sum(1)
            _i32(linfo + 16 * (leaf0 + l), 4)[:] = (
                tile0 + starts[l], tile0 + starts[l + 1], row[l], meta[l])
        return 0

    def fused_update_finalize_launch(self, mode, L, E, H, G, b1, b2,
                                     partials, linfo, table, loss, out, coef,
                                     clip, tg, count, stream):
        self.calls.append(f"finalize{mode}")
        f32 = np.float32
        tmax = _f32(table, 2 * E).reshape(E, 2)
        tsum = _f32(table + 8 * E, 22 * E).reshape(E, 22)
        if mode & 1:
            for first, stop, r, meta in _i32(linfo, 4 * L).reshape(
                    L, 4).tolist():
                rows = _f32(partials + 4 * first * fu.PARTIAL,
                            (stop - first) * fu.PARTIAL).reshape(-1,
                                                                 fu.PARTIAL)
                u = rows.view(np.uint32).astype(np.int64)
                gt = u[:, 4:].sum(0)
                be, counted = meta & fu.BACKEND, meta & fu.COUNTED
                tmax[r] = 0.0
                tmax[r, be] = rows[:, 1].max()
                tsum[r] = 0.0
                tsum[r, 2 + be] = u[:, 2].sum()
                if counted:
                    tsum[r, be] = rows[:, 0].sum(dtype=f32)
                    tsum[r, 4:] = np.concatenate([
                        [f32(u[:, 3].sum()) - f32(gt[0])],
                        gt[:-1].astype(f32) - gt[1:].astype(f32),
                        [f32(gt[-1])]])
        if mode & 2:
            sq = tsum[:, :2].sum(0, dtype=f32)
            mx = tmax.max(0) if E else np.zeros(2, f32)
            fin = (tsum[:, 2:4].sum(0) == 0).astype(f32)
            norm = np.sqrt(sq)
            o = _f32(out, fu.N_METRICS + 18 * H)
            o[:6] = [norm[0], mx[0], fin[0], norm[1], mx[1], fin[1]]
            ok = bool(np.isfinite(_f32(loss, 1)[0]) and fin.all())
            o[6] = 0.0 if ok else 1.0
            o[fu.N_METRICS:] = tsum[:H, 4:].reshape(-1)
            c = _f32(coef, 1 + 3 * G)
            c[0] = 1.0 if ok else 0.0
            for g in range(G):
                nrm, cl = norm[tg[g]], f32(clip[g])
                c[1 + 3 * g] = 1.0 if nrm < cl else (f32(1.0) / nrm) * cl
                cur = _i32(_arr(count)[g], 1)
                step = f32(cur[0] + 1)
                c[2 + 3 * g] = f32(1.0) - f32(b1) ** step
                c[3 + 3 * g] = f32(1.0) - f32(b2) ** step
                if ok:
                    cur[0] += 1
        return 0

    def fused_update_adam_launch(self, buf, coef, lr_scale, lr_value, wd,
                                 eps, b1, b2, c1, c2, neg_lr, G, stream):
        self.calls.append("adam")
        f32 = np.float32
        c = _f32(coef, 1 + 3 * G)
        if c[0] == 0.0:
            return 0
        ls = _f32(lr_scale, 1)[0] if lr_scale else f32(lr_value)
        k, _, _, _, n, _, meta, addr = self.table(buf)
        for l in range(k):
            grp = (int(meta[l]) >> fu.GROUP_SHIFT) - 1
            if grp < 0:
                continue
            g, p, m, v = (_f32(int(addr[i, l]), int(n[l])) for i in range(4))
            factor, bc1, bc2 = c[1 + 3 * grp:4 + 3 * grp]
            u = g * factor + f32(wd) * p
            m[:] = m * f32(b1) + f32(c1) * u
            v[:] = v * f32(b2) + f32(c2) * (u * u)
            den = np.sqrt(v / bc2) + f32(eps)
            p += ((m / bc1) / den) * f32(neg_lr[grp]) * ls
        return 0
