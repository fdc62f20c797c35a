"""AuralNet: a fixed filterbank and three transformer attention blocks
over the shared body and sector heads.

Counterpart of ``biear_tpu/models/auralnet.py``: per ear the fixed-Q
magnitude filterbank (``frontend.auralnet_fb``), log compression, three
pre-norm transformer encoders (left, right, left minus right) with a
sinusoidal positional encoding, a mean over the frames, then the CC
projection, body and heads of the BiEAR models. Eval mode is
``train=False``; ``.train()`` mode needs a ``torch.Generator`` for the
dropout masks, as JAX needs ``rng``.

Parameter names are the reference's (AuralNetActiveWaveform):
``attn_L.proj.*``, ``attn_L.encoder.layers.{i}.self_attn.in_proj_weight``
/ ``in_proj_bias`` / ``out_proj.*``, ``norm1``, ``norm2``, ``linear1``,
``linear2``, and ``cc_proj``, ``body.*``, ``subheads.*``. The layers are
written with plain products and ``softmax``, not ``nn.MultiheadAttention``
or ``nn.TransformerEncoderLayer``: their dropout draws from the global
generator and their eval fast path computes differently. GELU is exact;
LayerNorm eps is 1e-5.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import constant_cache, matmul_precision, resolve_device
from .backend import SubHead, SubHeads, make_body
from .biear import check_gen
from .config import BiEARConfig
from .frontend import auralnet_fb, device_constants
from .layers import dropout, init_module_, uniform_


@functools.lru_cache(maxsize=None)
def sinusoidal_pe(T: int, d_model: int) -> np.ndarray:
    """The transformer's sinusoidal positional encoding (T, d_model), a
    numpy constant."""
    position = np.arange(T, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * (-math.log(10000.0) / max(d_model, 1)))
    pe = np.zeros((T, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


@constant_cache
def device_pe(T: int, d_model: int, device: torch.device) -> torch.Tensor:
    """sinusoidal_pe as a tensor on `device`, copied there once (not on
    every forward)."""
    return torch.as_tensor(sinusoidal_pe(T, d_model), device=device)


class MultiheadSelfAttention(nn.Module):
    """Self-attention over (B, T, d) with torch's packed q, k, v layout:
    ``in_proj_weight`` (3d, d), ``in_proj_bias`` (3d,), ``out_proj``."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, gen: torch.Generator | None,
                train: bool, rate: float) -> torch.Tensor:
        B, T, d = x.shape
        hd = d // self.n_heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (a.reshape(B, T, self.n_heads, hd).transpose(1, 2)
                   for a in qkv.chunk(3, dim=-1))
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        attn = dropout(gen, attn, rate, not train)
        out = (attn @ v).transpose(1, 2).reshape(B, T, d)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Pre-norm transformer encoder layer with an exact GELU feed-forward
    (d -> 4d -> d); dropout on the attention weights, both residuals and
    after the GELU."""

    def __init__(self, d_model: int, n_heads: int, rate: float):
        super().__init__()
        self.rate = rate
        self.self_attn = MultiheadSelfAttention(d_model, n_heads)
        self.linear1 = nn.Linear(d_model, 4 * d_model)
        self.linear2 = nn.Linear(4 * d_model, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, x: torch.Tensor, gen: torch.Generator | None = None,
                train: bool = False) -> torch.Tensor:
        r, off = self.rate, not train
        a = self.self_attn(self.norm1(x), gen, train, r)
        x = x + dropout(gen, a, r, off)
        h = F.gelu(self.linear1(self.norm2(x)), approximate="none")
        h = self.linear2(dropout(gen, h, r, off))
        return x + dropout(gen, h, r, off)


class EncoderStack(nn.Module):
    """The encoder layers (``encoder.layers.{i}``)."""

    def __init__(self, d_model: int, n_heads: int, n_layers: int,
                 rate: float):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(d_model, n_heads, rate)
                                    for _ in range(n_layers))

    def forward(self, x, gen=None, train: bool = False):
        for layer in self.layers:
            x = layer(x, gen, train)
        return x


class AttnBlock(nn.Module):
    """Linear projection (d_in -> d_model), the positional encoding and
    the encoder stack: (B, T, d_in) -> (B, T, d_model)."""

    def __init__(self, d_in: int, cfg: BiEARConfig):
        super().__init__()
        self.proj = nn.Linear(d_in, cfg.d_model)
        self.encoder = EncoderStack(cfg.d_model, cfg.attn_heads,
                                    cfg.attn_layers, cfg.attn_dropout)

    def forward(self, x: torch.Tensor, gen=None, train: bool = False):
        h = self.proj(x)
        pe = device_pe(x.shape[1], h.shape[-1], h.device)
        return self.encoder(h + pe[None], gen, train)


class AuralNet(nn.Module):
    """Waveforms (B, Nsamp) x2 and the CC feature x3 (B, N) or None (zeros)
    -> (sound_logits (B, S), aoa (B, S), dist_logits (B, S, C), aux with
    Q None)."""

    def __init__(self, cfg: BiEARConfig):
        super().__init__()
        self.cfg = cfg
        self.attn_L = AttnBlock(cfg.n_bands, cfg)
        self.attn_R = AttnBlock(cfg.n_bands, cfg)
        self.attn_diff = AttnBlock(cfg.n_bands, cfg)
        feat_dim = 3 * cfg.d_model
        if cfg.use_cc:
            self.cc_proj = nn.Linear(cfg.n_bands, cfg.d_model)
            feat_dim += cfg.d_model
        self.body = make_body(feat_dim, cfg.backend_dropout)
        self.subheads = SubHeads(
            SubHead(200, cfg.n_dist_class, cfg.backend_dropout)
            for _ in range(cfg.n_sectors))
        self.eval()

    def init_weights_(self, seed: int) -> "AuralNet":
        """Seeded init from a CPU ``torch.Generator``: torch's Linear and
        LayerNorm defaults, the packed in-projection xavier-uniform (fan
        3d + d) with a zero bias."""
        gen = torch.Generator().manual_seed(seed)
        init_module_(self, gen)
        for m in self.modules():
            if isinstance(m, MultiheadSelfAttention):
                d = m.in_proj_weight.shape[1]
                uniform_(m.in_proj_weight, math.sqrt(6.0 / (4 * d)), gen)
                with torch.no_grad():
                    m.in_proj_bias.zero_()
        return self

    def forward(self, wavL: torch.Tensor, wavR: torch.Tensor,
                x3: torch.Tensor | None = None,
                gen: torch.Generator | None = None):
        train = check_gen(self, gen)
        cfg = self.cfg
        with matmul_precision():
            wavL = torch.clamp(wavL.float(), -1.0, 1.0)
            wavR = torch.clamp(wavR.float(), -1.0, 1.0)
            c = device_constants(cfg, wavL.device)
            xL = torch.clamp(torch.log(auralnet_fb(cfg, wavL, c) + 1e-8),
                             -12.0, 12.0)
            xR = torch.clamp(torch.log(auralnet_fb(cfg, wavR, c) + 1e-8),
                             -12.0, 12.0)
            feats = [self.attn_L(xL, gen, train).mean(dim=1),
                     self.attn_R(xR, gen, train).mean(dim=1),
                     self.attn_diff(xL - xR, gen, train).mean(dim=1)]
            if cfg.use_cc:
                if x3 is None:
                    x3 = wavL.new_zeros((wavL.shape[0], cfg.n_bands))
                feats.append(self.cc_proj(x3.float()))
            body = self.body(torch.cat(feats, -1), gen, train)
            sound, aoa, dist = self.subheads(body, gen, train)
        return sound.float(), aoa.float(), dist.float(), {"Q": None}


def build_auralnet(cfg: BiEARConfig, seed: int = 0, device=None) -> AuralNet:
    """A seeded AuralNet on `device` (the card unless device='cpu')."""
    device = resolve_device(device)
    return AuralNet(cfg).init_weights_(seed).to(device)
