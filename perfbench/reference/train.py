"""Plain reference of the training step: synthesis, forward, loss,
gradients by autograd, and Adam with per-group clipping.

Adam as configured: parameters under ``bifb.`` (the Q-controllers) form
the frontend group, the rest the backend group (one group under the
global clip when there is no frontend). Per group: clip the gradient by
the group's global norm, add ``weight_decay * p`` (the update the
optimizer is given), then Adam (b1 0.9, b2 0.999, eps, bias-corrected)
at the group's learning rate. A step whose loss or any gradient is not
finite changes nothing.
"""

from __future__ import annotations

import torch

from . import model as M

B1, B2 = 0.9, 0.999


def groups(names: list, hp: dict) -> list:
    """[(names, lr, clip)] of the configured optimizer."""
    fe = [n for n in names if n.startswith("bifb.")]
    be = [n for n in names if not n.startswith("bifb.")]
    if not fe:
        return [(be, hp["lr_backend"], hp["grad_clip_norm"])]
    return [(fe, hp["lr_fb"], hp["clip_fb"]),
            (be, hp["lr_backend"], hp["clip_backend"])]


class Trainer:
    """The configured model's parameters and Adam state, stepped on
    batches drawn from `scene` with `gen` (synthesis first, then the
    dropout masks of the step)."""

    def __init__(self, cfg: dict, hp: dict, params: dict, scene, device):
        self.cfg, self.hp, self.scene = cfg, hp, scene
        self.c = M.constants(cfg, device)
        self.P = {k: v.detach().clone().float() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.P.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.P.items()}
        self.count = 0

    def grads(self, batch, gen):
        """(loss, {name: gradient}) of one training forward."""
        names = list(self.P)
        leaves = [self.P[n].requires_grad_(True) for n in names]
        with M.no_tf32():
            loss = M.loss(self.cfg, self.hp, self.c, self.P, batch, gen)
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
        for n in names:
            self.P[n] = self.P[n].detach()
        return loss.detach(), {n: torch.zeros_like(self.P[n]) if x is None
                               else x for n, x in zip(names, g)}

    @torch.no_grad()
    def update(self, grads: dict, ok: bool) -> dict:
        """One Adam step; returns the updates u = clipped g + wd p that
        the moments take in."""
        hp, self.count = self.hp, self.count + (1 if ok else 0)
        us = {}
        for names, lr, clip in groups(list(self.P), hp):
            norm = torch.sqrt(sum((grads[n].double() ** 2).sum()
                                  for n in names))
            f = 1.0 if norm < clip else clip / norm
            for n in names:
                u = grads[n] * f + hp["weight_decay"] * self.P[n]
                us[n] = u
                if not ok:
                    continue
                self.m[n] = B1 * self.m[n] + (1 - B1) * u
                self.v[n] = B2 * self.v[n] + (1 - B2) * u * u
                mh = self.m[n] / (1 - B1 ** self.count)
                vh = self.v[n] / (1 - B2 ** self.count)
                self.P[n] = self.P[n] - lr * mh / (torch.sqrt(vh)
                                                   + hp["adam_eps"])
        return us

    def step(self, gen, batch_size: int) -> dict:
        """One synthesize -> train step: {"loss", "grads", "updates",
        "batch"}."""
        with M.no_tf32(), torch.no_grad():
            wl, wr, x3, y = self.scene.batch(gen, batch_size)
        batch = (wl.float(), wr.float(), x3, y)
        loss, g = self.grads(batch, gen)
        ok = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(x).all()) for x in g.values())
        return {"loss": float(loss), "grads": g,
                "updates": self.update(g, ok), "ok": ok}
