"""Optimizer: frontend / backend parameter groups, per-group gradient
clipping, Adam with torch's numerics, a masked skip, and the plateau LR
scale.

Counterpart of ``biear_tpu/train/optim.py``. Every parameter under
``bifb.`` (the Q-controllers) is frontend, the rest backend. Each group
runs, in this order: clip by the group's global norm -> add ``wd * p``
(L2-style decay on the clipped gradient, as torch.optim.Adam's
weight_decay) -> Adam (b1 0.9, b2 0.999, eps 1e-7, bias-corrected) ->
``-lr`` -> the plateau scale.

The moments of a parameter cut over a model axis live with its piece on
each rank; the group's clip norm is then the whole gradient's, passed in
by the train step.

Written by hand on tensor lists, not torch.optim.Adam: the step takes a
device-side ``ok`` flag and, when it is false (a nonfinite loss or
gradient), leaves the parameters, both moments and the step count exactly
as they were, with ``torch.where`` and no host sync, as the JAX package's
masked update does. On a card, ``fused_update.py`` does the step (and the
telemetry) in three kernel launches over the same state; ``Adam.step`` is
its plain version.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

B1, B2 = 0.9, 0.999


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    lr_fb: float = 5e-5
    lr_backend: float = 1e-4
    weight_decay: float = 1e-5
    clip_fb: float = 0.2
    clip_backend: float = 3.0
    grad_clip_norm: float = 3.0      # global clip when no frontend group
    adam_eps: float = 1e-7
    reg_q_w: float = 1e-3
    reg_smooth_w: float = 1e-3
    loss_w_sound: float = 0.2
    loss_w_aoa: float = 0.45
    loss_w_dist: float = 0.35
    pos_weight: float = 3.0


def is_frontend(name: str) -> bool:
    """Frontend parameters are those of the 'bifb' subtree."""
    return name.startswith("bifb.")


@dataclasses.dataclass
class ParamGroup:
    """One optimizer group: its parameters (by name), hyper-parameters and
    Adam state (first and second moments, step count). A frozen group gets
    no update and keeps no state."""
    label: str
    names: list
    params: list
    lr: float = 0.0
    clip: float = 0.0
    frozen: bool = False
    m: list = dataclasses.field(default_factory=list)
    v: list = dataclasses.field(default_factory=list)
    count: torch.Tensor | None = None


class Adam:
    """Adam over named parameter groups with a masked, sync-free step."""

    def __init__(self, groups: list, weight_decay: float, eps: float):
        self.groups = groups
        self.weight_decay = weight_decay
        self.eps = eps
        for g in groups:
            if not g.frozen:
                g.m = [torch.zeros_like(p) for p in g.params]
                g.v = [torch.zeros_like(p) for p in g.params]
                dev = g.params[0].device if g.params else None
                g.count = torch.zeros((), dtype=torch.int32, device=dev)

    def state_dict(self) -> dict:
        """The Adam state on the CPU, by group label: {"count": int32
        0-dim, "m": {name: tensor}, "v": {name: tensor}}. A frozen group
        keeps no state and has no entry."""
        def cpu(t):
            return t.detach().to("cpu", copy=True)
        return {g.label: {"count": cpu(g.count),
                          "m": {n: cpu(t) for n, t in zip(g.names, g.m)},
                          "v": {n: cpu(t) for n, t in zip(g.names, g.v)}}
                for g in self.groups if not g.frozen}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore `state` (the layout of ``state_dict``) in place, on the
        parameters' device. Groups, names and shapes must match; the
        order of the names does not matter."""
        live = {g.label: g for g in self.groups if not g.frozen}
        if set(state) != set(live):
            raise ValueError(f"optimizer groups {sorted(state)} do not match "
                             f"this optimizer's {sorted(live)}")
        for label, g in live.items():
            st = state[label]
            for key, dst in (("m", g.m), ("v", g.v)):
                if set(st[key]) != set(g.names):
                    raise ValueError(f"group {label!r}: the {key} names do "
                                     "not match the model's parameters")
                for n, t in zip(g.names, dst):
                    src = st[key][n]
                    if tuple(src.shape) != tuple(t.shape):
                        raise ValueError(f"{label}.{key}[{n}]: shape "
                                         f"{tuple(src.shape)}, model "
                                         f"{tuple(t.shape)}")
                    t.copy_(src)
            g.count.copy_(torch.as_tensor(st["count"], dtype=torch.int32))

    @torch.no_grad()
    def step(self, grads: dict, ok: torch.Tensor, lr_scale=1.0,
             norms: dict | None = None) -> None:
        """One update from `grads` (name -> gradient) where `ok` (a bool
        tensor) is true; where it is false nothing changes. `lr_scale` is
        a float or a 0-dim tensor on the parameters' device, a tensor
        operand of the update (a captured step reads its value at each
        replay; the same bits as the float). `norms` gives each group's
        clip norm by label (the whole gradient's, for a model cut over a
        model axis); by default it is the norm of `grads`."""
        for g in self.groups:
            if not g.frozen and g.params:
                self._update(g, [grads[n] for n in g.names], ok, lr_scale,
                             None if norms is None else norms[g.label])

    def _update(self, g: ParamGroup, grads: list, ok: torch.Tensor,
                lr_scale, norm=None) -> None:
        if norm is None:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
        factor = torch.where(norm < g.clip, 1.0, g.clip / norm)
        u = torch._foreach_mul(grads, factor)
        torch._foreach_add_(u, g.params, alpha=self.weight_decay)
        m = torch._foreach_mul(g.m, B1)
        torch._foreach_add_(m, u, alpha=1.0 - B1)
        v = torch._foreach_mul(g.v, B2)
        torch._foreach_addcmul_(v, u, u, value=1.0 - B2)
        count = g.count + 1
        bc1 = 1.0 - torch.pow(B1, count.float())
        bc2 = 1.0 - torch.pow(B2, count.float())
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        step = torch._foreach_div(m, bc1)
        torch._foreach_div_(step, den)
        torch._foreach_mul_(step, -g.lr)
        torch._foreach_mul_(step, lr_scale)
        new_p = torch._foreach_add(g.params, step)
        for p, pn, mo, mn, vo, vn in zip(g.params, new_p, g.m, m, g.v, v):
            p.copy_(torch.where(ok, pn, p))
            mo.copy_(torch.where(ok, mn, mo))
            vo.copy_(torch.where(ok, vn, vo))
        g.count.copy_(torch.where(ok, count, g.count))


def make_optimizer(model: nn.Module, hp: TrainHyper,
                   freeze_controller: bool = False) -> Adam:
    """The reference's optimizer: a frontend group (lr_fb, clip_fb) and a
    backend group (lr_backend, clip_backend); one group over everything
    under the global clip when the frontend has no parameters (fixed Q);
    with freeze_controller the frontend gets no update and the backend
    trains under the global clip."""
    named = list(model.named_parameters())
    fe = [(n, p) for n, p in named if is_frontend(n)]
    be = [(n, p) for n, p in named if not is_frontend(n)]

    def group(label, pairs, **kw):
        return ParamGroup(label, [n for n, _ in pairs], [p for _, p in pairs],
                          **kw)

    if freeze_controller:
        groups = [group("frozen", fe, frozen=True),
                  group("backend", be, lr=hp.lr_backend,
                        clip=hp.grad_clip_norm)]
    elif not fe:
        groups = [group("backend", be, lr=hp.lr_backend,
                        clip=hp.grad_clip_norm)]
    else:
        groups = [group("frontend", fe, lr=hp.lr_fb, clip=hp.clip_fb),
                  group("backend", be, lr=hp.lr_backend,
                        clip=hp.clip_backend)]
    return Adam(groups, hp.weight_decay, hp.adam_eps)


class PlateauScheduler:
    """Host-side ReduceLROnPlateau(mode=min, factor, patience) with torch's
    default relative threshold 1e-4. Its scale multiplies the updates."""

    def __init__(self, factor: float = 0.5, patience: int = 10,
                 threshold: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if not math.isfinite(metric):
            self.num_bad += 1
        elif metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.scale *= self.factor
            self.num_bad = 0
        return self.scale
