"""Backend: ILD / IPD GRU encoders, body MLP and the per-sector sub-heads.

Counterpart of ``biear_tpu/models/backend.py``. Module and index names
follow the reference checkpoints (``body.{0,3,6}``,
``subheads.{k}.shared.0``, ``subheads.{k}.sound.{0,2,4}``, ...). In
training, dropout masks come from the generator passed to ``forward``;
the ``nn.Dropout`` modules only hold their indices.
"""

from __future__ import annotations

import torch
from torch import nn

import torch.nn.functional as F

from ..parallel.mesh import copy_to_model, gather_heads, reduce_from_model
from .layers import GRU, dropout


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


class Encoder(nn.Module):
    """LayerNorm -> GRU(in -> hidden) -> GRU(hidden -> latent) -> time mean."""

    def __init__(self, input_dim: int, hidden_dim: int = 200,
                 latent_dim: int = 100):
        super().__init__()
        self.in_norm = nn.LayerNorm(input_dim)
        self.gru1 = GRU(input_dim, hidden_dim)
        self.gru2 = GRU(hidden_dim, latent_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h1, _ = self.gru1(self.in_norm(x))
        h2, _ = self.gru2(h1)
        return _finite(h2.mean(dim=1))


def ild_features(xL: torch.Tensor, xR: torch.Tensor) -> torch.Tensor:
    """ILD = clamp(nan_to_num(xL - xR), +-10)."""
    return torch.clamp(_finite(xL - xR), -10.0, 10.0)


def ipd_features(xL: torch.Tensor, xR: torch.Tensor) -> torch.Tensor:
    """IPD = atan2(sin d, cos d) of d = xL - xR, then nan_to_num."""
    d = xL - xR
    return _finite(torch.atan2(torch.sin(d), torch.cos(d)))


class Body(nn.Sequential):
    """Linear 512 -> 400 -> 200, each followed by ReLU and Dropout."""

    mesh = None                   # set by shard_

    def __init__(self, feat_dim: int, rate: float):
        super().__init__(
            nn.Linear(feat_dim, 512), nn.ReLU(), nn.Dropout(rate),
            nn.Linear(512, 400), nn.ReLU(), nn.Dropout(rate),
            nn.Linear(400, 200), nn.ReLU(), nn.Dropout(rate))
        self.rate = rate

    @torch.no_grad()
    def shard_(self, mesh) -> None:
        """Keep this model rank's share of body.0's outputs and of body.3's
        inputs."""
        k = self[0].out_features // mesh.model
        cut = slice(mesh.model_rank * k, (mesh.model_rank + 1) * k)
        l0, l3 = self[0], self[3]
        l0.weight = nn.Parameter(l0.weight[cut].clone())
        l0.bias = nn.Parameter(l0.bias[cut].clone())
        l3.weight = nn.Parameter(l3.weight[:, cut].clone())
        l0.out_features = l3.in_features = k
        self.mesh = mesh

    def forward(self, x: torch.Tensor, gen: torch.Generator | None = None,
                train: bool = False) -> torch.Tensor:
        off = not train
        if self.mesh is None:
            for i in (0, 3, 6):
                x = dropout(gen, torch.relu(self[i](x)), self.rate, off)
            return x
        h = self[0](copy_to_model(x, self.mesh))
        h = dropout(gen, torch.relu(h), self.rate, off, sharded=True)
        h = reduce_from_model(F.linear(h, self[3].weight), self.mesh)
        h = dropout(gen, torch.relu(h + self[3].bias), self.rate, off)
        return dropout(gen, torch.relu(self[6](h)), self.rate, off)


def make_body(feat_dim: int, rate: float) -> Body:
    return Body(feat_dim, rate)


def _branch(out_dim: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(100, 50), nn.ReLU(), nn.Linear(50, 10),
                         nn.ReLU(), nn.Linear(10, out_dim))


class SubHead(nn.Module):
    """One sector: shared Linear(200 -> 100) + ReLU + Dropout, then the
    sound, AoA and distance branches."""

    def __init__(self, body_dim: int = 200, n_dist_class: int = 5,
                 rate: float = 0.2):
        super().__init__()
        self.shared = nn.Sequential(nn.Linear(body_dim, 100), nn.ReLU(),
                                    nn.Dropout(rate))
        self.sound = _branch(1)
        self.aoa = _branch(1)
        self.dist = _branch(n_dist_class)
        self.rate = rate

    def forward(self, x: torch.Tensor, gen: torch.Generator | None = None,
                train: bool = False, sharded: bool = False):
        h = dropout(gen, torch.relu(self.shared[0](x)), self.rate, not train,
                    sharded)
        return (self.sound(h)[..., 0], torch.sigmoid(self.aoa(h))[..., 0],
                self.dist(h))


class SubHeads(nn.ModuleList):
    """The sector heads: (B, 200) -> sound logits (B, S), AoA in [0, 1]
    (B, S), distance logits (B, S, C)."""

    mesh = None                   # set by shard_

    def shard_(self, mesh) -> None:
        """Keep this model rank's heads, under their usual indices."""
        self.n_heads = len(self)
        h = self.n_heads // mesh.model
        self.first = mesh.model_rank * h
        for k in range(self.n_heads):
            if not self.first <= k < self.first + h:
                del self._modules[str(k)]
        self.mesh = mesh

    def forward(self, x: torch.Tensor, gen: torch.Generator | None = None,
                train: bool = False):
        cut = self.mesh is not None
        if cut:
            x = copy_to_model(x, self.mesh)
        sound, aoa, dist = zip(*(head(x, gen, train, cut) for head in self))
        sound, aoa = torch.stack(sound, dim=-1), torch.stack(aoa, dim=-1)
        dist = torch.stack(dist, dim=1)
        if not cut:
            return sound, aoa, dist
        full = gather_heads(torch.cat([sound[..., None], aoa[..., None],
                                       dist], dim=-1),
                            self.first, self.n_heads, self.mesh)
        return full[..., 0], full[..., 1], full[..., 2:]
