"""Layers of the port, in PyTorch's own modules.

Counterpart of ``biear_tpu/models/layers.py``. The JAX layers keep torch's
weight layout (Linear (out, in); GRU gates r, z, n stacked in (3H, .)), so
``nn.Linear``, ``nn.LayerNorm`` (eps 1e-5), ``nn.SiLU`` and ``nn.GRU`` are
the same functions with the same parameter names. ``GRU`` adds a one-step
call for the Q-controller, whose input depends on the carried state.

Dropout on the training path draws its masks from an explicit
``torch.Generator``, or from a rank's ``RankGenerators`` under a mesh
(``dropout``, ``dropout_masks``, ``dropout_apply``);
the ``nn.Dropout`` modules in the model only keep the reference's module
indices and are never called.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..device import autocast_bf16


class GRU(nn.GRU):
    """Single-layer batch-first GRU (gate order r, z, n) with a step call.

    Its parameters are torch's ``weight_ih_l0``, ``weight_hh_l0``,
    ``bias_ih_l0`` and ``bias_hh_l0``, the names of the reference
    checkpoints."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True)

    def forward(self, x: torch.Tensor, hx: torch.Tensor | None = None):
        """nn.GRU's forward; under the bf16 policy's autocast on the card,
        a loop of ``step`` in bf16, since cuDNN's RNN casts itself to
        float16 under autocast whatever its dtype."""
        if not autocast_bf16(x):
            return super().forward(x, hx)
        h = x.new_zeros(x.shape[0], self.hidden_size) if hx is None else hx[0]
        hs = []
        for t in range(x.shape[1]):
            h = self.step(x[:, t], h)
            hs.append(h)
        return torch.stack(hs, dim=1), h[None]

    def step(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """One GRU step: x (B, I), h (B, H) -> h' (B, H)."""
        return torch.gru_cell(x, h, self.weight_ih_l0, self.weight_hh_l0,
                              self.bias_ih_l0, self.bias_hh_l0)


def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    """In-place U(-bound, bound) from an explicit generator."""
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=gen, dtype=t.dtype,
                           device=gen.device) * (2 * bound) - bound)


def init_module_(module: nn.Module, gen: torch.Generator) -> None:
    """torch's default initialisers, drawn from `gen`: Linear weight and
    bias ~ U(+-1/sqrt(fan_in)), GRU ~ U(+-1/sqrt(hidden)), LayerNorm
    ones/zeros. Modules are visited in registration order."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            uniform_(m.weight, bound, gen)
            uniform_(m.bias, bound, gen)
        elif isinstance(m, nn.GRU):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters(recurse=False):
                uniform_(p, bound, gen)
        elif isinstance(m, nn.LayerNorm):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()


class RankGenerators:
    """The dropout streams of one rank of a data x model mesh.

    `shared` is in the same state on every rank (it drew the synthesised
    batch); `replicated` draws the masks of activations every model rank
    holds whole, `sharded` those of activations cut over the model axis.
    Every mask is also drawn from `shared`, so that it stays in step on
    every rank; where the stream of the activation is `shared` itself,
    that draw is the mask."""

    def __init__(self, shared: torch.Generator, replicated: torch.Generator,
                 sharded: torch.Generator):
        self.shared = shared
        self.replicated = replicated
        self.sharded = sharded

    def keep_masks(self, rate: float, shape, sharded: bool) -> torch.Tensor:
        own = self.sharded if sharded else self.replicated
        keep = _keep(self.shared, rate, shape)
        return keep if own is self.shared else _keep(own, rate, shape)


def _keep(gen: torch.Generator, rate: float, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) < 1.0 - rate


def dropout_masks(gen, rate: float, shape,
                  sharded: bool = False) -> torch.Tensor:
    """Keep-masks (True = keep, probability 1 - rate) for dropout_apply,
    drawn in one call from an explicit generator on its device, or from a
    rank's ``RankGenerators`` (`sharded`: the activation is cut over the
    model axis)."""
    if isinstance(gen, RankGenerators):
        return gen.keep_masks(rate, shape, sharded)
    return _keep(gen, rate, shape)


def dropout_apply(mask: torch.Tensor, x: torch.Tensor,
                  rate: float) -> torch.Tensor:
    """Inverted dropout from a precomputed keep-mask."""
    return torch.where(mask, x / (1.0 - rate), 0.0)


def dropout(gen, x: torch.Tensor, rate: float, deterministic: bool,
            sharded: bool = False) -> torch.Tensor:
    """Inverted dropout with torch.nn.Dropout's semantics, but with masks
    from `gen` (a generator or ``RankGenerators``) rather than the global
    generator; the identity when deterministic or rate <= 0."""
    if deterministic or rate <= 0.0:
        return x
    return dropout_apply(dropout_masks(gen, rate, x.shape, sharded), x, rate)
