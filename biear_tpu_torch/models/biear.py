"""The BiEAR models: the active waveform model (dual or single
Q-controller, or fixed Q) and the passive feature model.

Counterparts of ``biear_tpu/models/biear.py::active_forward`` and
``passive_forward``: eval mode is ``train=False``; ``.train()`` mode is
``train=True`` and needs a ``torch.Generator`` for the dropout masks, as
JAX needs ``rng``. Parameter names are those of the reference checkpoints
(DeepEarActiveWaveform, DeepEarTorchILD), so a state dict from
``models.weights.state_dict_from_jax`` or a reference-format ``.pth``
loads with ``strict=True``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import matmul_precision, resolve_device
from .backend import (Encoder, SubHead, SubHeads, ild_features, ipd_features,
                      make_body)
from .config import BiEARConfig
from .frontend import make_frontend
from .layers import init_module_


class _Heads(nn.Module):
    """The backend both families share: the ILD and IPD encoders, the CC
    projection, the body and the sector heads."""

    def _add_backend(self, cfg: BiEARConfig) -> None:
        self.encoder_ild = Encoder(cfg.n_bands, 200, cfg.latent_dim)
        self.encoder_ipd = Encoder(cfg.n_bands, 200, cfg.latent_dim)
        feat_dim = 2 * cfg.latent_dim
        if cfg.use_cc:
            self.cc_proj = nn.Linear(cfg.n_bands, cfg.latent_dim)
            feat_dim += cfg.latent_dim
        self.body = make_body(feat_dim, cfg.backend_dropout)
        self.subheads = SubHeads(
            SubHead(200, cfg.n_dist_class, cfg.backend_dropout)
            for _ in range(cfg.n_sectors))

    def heads(self, z_ild: torch.Tensor, z_ipd: torch.Tensor,
              x3: torch.Tensor | None, gen: torch.Generator | None = None,
              train: bool = False):
        """Encoder summaries (B, latent) x2 and x3 (B, N) or None (zeros)
        -> (sound_logits, aoa, dist_logits): the CC projection, body and
        sector heads (JAX ``_heads``), shared by ``forward`` and the
        streaming readout."""
        feats = [z_ild, z_ipd]
        if self.cfg.use_cc:
            if x3 is None:
                x3 = z_ild.new_zeros((z_ild.shape[0], self.cfg.n_bands))
            feats.append(self.cc_proj(x3))
        body = self.body(torch.cat(feats, -1), gen, train)
        return self.subheads(body, gen, train)


def check_gen(model: nn.Module, gen) -> bool:
    """The model's training flag; training mode needs a generator for the
    dropout masks."""
    if model.training and gen is None:
        raise ValueError(f"{type(model).__name__} in training mode "
                         "requires a torch.Generator for dropout: pass "
                         "gen= or call .eval()")
    return model.training


class ActiveBiEAR(_Heads):
    """Waveforms (B, Nsamp) x2 and the CC feature x3 (B, N) ->
    (sound_logits (B, S), aoa (B, S), dist_logits (B, S, C), aux with Q).

    ``cfg.controller_mode`` picks the frontend: "single" one shared
    controller, anything else two per-ear ones (the JAX dispatch)."""

    def __init__(self, cfg: BiEARConfig):
        super().__init__()
        self.cfg = cfg
        self.bifb = make_frontend(cfg)
        self._add_backend(cfg)
        self.eval()

    def init_weights_(self, seed: int) -> "ActiveBiEAR":
        """Seeded init from a CPU ``torch.Generator``: torch's defaults,
        with each controller's output layer at zero (Q starts at Q0)."""
        gen = torch.Generator().manual_seed(seed)
        init_module_(self, gen)
        with torch.no_grad():
            for ctrl in self.bifb.controllers():
                ctrl.q_out[8].weight.zero_()
                ctrl.q_out[8].bias.zero_()
        return self

    def forward(self, wavL: torch.Tensor, wavR: torch.Tensor,
                x3: torch.Tensor | None = None,
                gen: torch.Generator | None = None):
        """In .train() mode `gen` (on the model's device) draws the dropout
        masks, frontend first, then body and heads."""
        train = check_gen(self, gen)
        with matmul_precision():
            wavL, wavR = wavL.float(), wavR.float()
            YL, YR, QL, QR, phL, phR = self.bifb(wavL, wavR, gen, train)
            x1 = torch.clamp(torch.log(YL + 1e-8), -12.0, 12.0)
            x2 = torch.clamp(torch.log(YR + 1e-8), -12.0, 12.0)
            sound, aoa, dist = self.heads(
                self.encoder_ild(ild_features(x1, x2)),
                self.encoder_ipd(ipd_features(phL, phR)), x3, gen, train)
        return (sound.float(), aoa.float(), dist.float(),
                {"QL": QL, "QR": QR, "Q": 0.5 * (QL + QR)})


def build_active(cfg: BiEARConfig, seed: int = 0, device=None) -> ActiveBiEAR:
    """A seeded ActiveBiEAR on `device` (the card unless device='cpu')."""
    device = resolve_device(device)
    return ActiveBiEAR(cfg).init_weights_(seed).to(device)


class PassiveBiEAR(_Heads):
    """Precomputed features -> (sound_logits, aoa, dist_logits, aux): the
    magnitude planes x1, x2 (B, T, N) into the ILD encoder, the phase
    planes x4, x5 (B, T, N) into the IPD encoder, the CC feature x3
    (B, N) into ``cc_proj``. No frontend (``passive_forward``)."""

    def __init__(self, cfg: BiEARConfig):
        super().__init__()
        self.cfg = cfg
        self._add_backend(cfg)
        self.eval()

    def init_weights_(self, seed: int) -> "PassiveBiEAR":
        """Seeded init from a CPU ``torch.Generator``: torch's defaults."""
        init_module_(self, torch.Generator().manual_seed(seed))
        return self

    def forward(self, x1, x2, x3, x4, x5,
                gen: torch.Generator | None = None):
        train = check_gen(self, gen)
        with matmul_precision():
            sound, aoa, dist = self.heads(
                self.encoder_ild(ild_features(x1, x2)),
                self.encoder_ipd(ipd_features(x4, x5)), x3, gen, train)
        return sound.float(), aoa.float(), dist.float(), {"Q": None}


def build_passive(cfg: BiEARConfig, seed: int = 0,
                  device=None) -> PassiveBiEAR:
    """A seeded PassiveBiEAR on `device` (the card unless device='cpu')."""
    device = resolve_device(device)
    return PassiveBiEAR(cfg).init_weights_(seed).to(device)
