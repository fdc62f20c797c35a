"""Streaming (frame-by-frame) inference for the active models.

Counterpart of ``biear_tpu/serve/streaming.py``. A real-time deployment
receives one hop of audio per stream per tick (win = hop = 842 samples,
52.6 ms at 16 kHz and 19 frames) and advances every concurrent stream by
one frame, instead of re-running a whole 1 s forward per hop:

    state = stream_init(model, batch)
    for each hop:  state = stream_step(model, state, chunkL, chunkR)
    sound, aoa, dist = stream_readout(model, state[, tailL, tailR])

The functions take the model (an ``ActiveBiEAR``), run under
``torch.inference_mode()`` with TF32 off, and keep their state as a dict
of tensors on the model's device (views of one flat buffer,
``StreamLayout``); the batch axis is the concurrent-streams axis, and
``stream_reset`` re-initialises slots when streams end (a masked fill).
On the card ``stream_step`` replays a captured CUDA graph of the hop per
(model, batch, precision), as JAX jits it; a state once returned is never
changed by a later hop. Dual, single and fixed-Q frontends stream.

Equivalence with the model's forward on the same 1 s crop (T hop-chunks,
then the fs - T * hop residual samples to ``stream_readout``):

  * the frontend runs the same per-frame method (``frame``) as the
    forward's loop, on the same spectra code (``frame_rhs`` or
    ``frame_spectra``; under the bf16 policy on the card one launch of
    ``kernels/spectra.cu`` a hop, a frame row with T = 1);
  * the encoders run ``in_norm`` and the GRU cells one frame at a time
    (``GRU.step``) and keep a running sum, where the forward runs the
    sequence through ``nn.GRU`` (cuDNN on the card) and takes a time mean:
    the same function, summed in another order;
  * the CC feature accumulates raw lag sums hop by hop over a K-sample
    halo (K = 48 at 16 kHz) and removes the means at readout by a closed
    form, where the forward centres the whole crop first.

So the outputs agree to rounding (2e-4 with the CC feature, 2e-6 without,
the tolerances of the JAX package's tests). Continuous operation past T
frames is defined: the readout is a running mean over all frames seen
(per-stream counters), though equality with the forward holds at T.
Only hop_ratio == 1 configurations stream (win == hop). AuralNet does
not stream: its self-attention needs all T frames at once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import constant_cache, precision_highest
from ..models.backend import ild_features, ipd_features
from ..models.biear import ActiveBiEAR
from ..models.config import BiEARConfig
from ..models.frontend import (device_constants, fixed_forward, frame_rhs,
                               frame_spectra)
from ..ops.framing import frame_params
from ..ops.xcorr import device_lag_plan, interp_to_lags, lag_plan
from ..graph import captured_forward, host_input, use_capture

GRU1_HIDDEN = 200


@functools.lru_cache(maxsize=None)
def stream_plan(cfg: BiEARConfig) -> dict:
    """Static geometry: frame size, the CC lag window K and interpolation
    plan (the batch path's ``lag_plan`` for a 1 s crop), and the residual
    tail the 1 s protocol leaves after T frames."""
    win, hop = frame_params(cfg.fs, cfg.timesteps, cfg.hop_ratio)
    if win != hop:
        raise NotImplementedError(
            "streaming inference requires hop_ratio == 1.0 (win == hop); "
            f"got win={win}, hop={hop}")
    kept = lag_plan(cfg.fs, cfg.fs, cfg.n_bands, 3.0)[0]
    K = int(np.max(np.abs(kept)))
    if len(kept) != 2 * K + 1:
        raise AssertionError("CC lag window is not contiguous")
    if win < K:
        raise NotImplementedError(
            f"first chunk must cover the CC head buffer: win={win} < K={K}")
    return {"win": win, "hop": hop, "K": K, "fs": cfg.fs,
            "num_lags": cfg.n_bands, "tail_len": cfg.fs - cfg.timesteps * hop}


def _device(model: ActiveBiEAR) -> torch.device:
    return next(model.parameters()).device


# ---------------- state ----------------

def _fresh_state(model: ActiveBiEAR, batch: int) -> dict:
    if not isinstance(model, ActiveBiEAR):
        raise NotImplementedError(
            f"{type(model).__name__} is not streamable: only the active "
            "models stream (AuralNet's self-attention needs all T frames, "
            "the encoder attends globally; the passive model's inputs are "
            "whole-utterance features)")
    cfg, dev = model.cfg, _device(model)
    z = lambda *s: torch.zeros(s, device=dev)
    fe = ()
    if not cfg.fixed_frontend_q:
        c = device_constants(cfg, dev)
        fe = tuple(a.contiguous() for a in model.bifb.init_carry(c, batch,
                                                                 dev))
    enc = lambda: {"h1": z(batch, GRU1_HIDDEN), "h2": z(batch, cfg.latent_dim),
                   "sum": z(batch, cfg.latent_dim)}
    state = {"t": torch.zeros(batch, dtype=torch.int32, device=dev),
             "fe": fe, "ild": enc(), "ipd": enc()}
    if cfg.use_cc:
        K = stream_plan(cfg)["K"]
        state["cc"] = {"raw": z(batch, 2 * K + 1),
                       "n": torch.zeros(batch, dtype=torch.int32, device=dev),
                       "sumL": z(batch), "sumR": z(batch),
                       "headL": z(batch, K), "headR": z(batch, K),
                       "tailL": z(batch, K), "tailR": z(batch, K)}
    return state


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(like, leaves):
    """The tree of `like`'s structure with the next items of the iterator
    `leaves` as its leaves."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    if isinstance(like, tuple):
        return tuple(_rebuild(v, leaves) for v in like)
    return next(leaves)


# each leaf's span starts at a multiple of ALIGN int32 elements (256
# bytes), as a separately allocated leaf would: cuBLAS picks its kernels
# by the operands' alignment, up to 256 bytes
ALIGN = 64


class StreamLayout:
    """The state of `batch` streams laid out in one flat int32 buffer:
    each leaf (4-byte float32 or int32) a reinterpreted view of its span,
    zero padding to the next multiple of ALIGN after it, so copying a
    state in or out is one launch. ``fresh`` is a fresh state's buffer,
    ``slot`` each element's stream (the frontend carry's streams axis is
    the frontend's ``STREAM_AXIS``, 1 for the ear-stacked dual carry; 0
    elsewhere; padding counts as stream 0)."""

    def __init__(self, model: ActiveBiEAR, batch: int):
        fresh = _fresh_state(model, batch)
        self.like = fresh
        leaves = _leaves(fresh)
        if any(x.element_size() != 4 for x in leaves):
            raise TypeError("stream state leaves must be 4-byte tensors")
        self.specs = [(x.shape, x.dtype) for x in leaves]
        self.pads = [-x.numel() % ALIGN for x in leaves]
        dev = leaves[0].device
        self.zeros = torch.zeros(ALIGN, dtype=torch.int32, device=dev)
        self.fresh = self.flatten(fresh)
        axes = [model.bifb.STREAM_AXIS if k == "fe" else 0
                for k, sub in fresh.items() for _ in _leaves(sub)]
        slots = []
        for x, axis, pad in zip(leaves, axes, self.pads):
            shape = [1] * x.ndim
            shape[axis] = batch
            slots += [torch.arange(batch, device=dev).reshape(shape)
                      .expand(x.shape).reshape(-1), self.zeros[:pad].long()]
        self.slot = torch.cat(slots)

    def flatten(self, state: dict) -> torch.Tensor:
        """The state's leaves, in order and padded, as one int32 buffer (a
        copy)."""
        parts = []
        for x, pad in zip(_leaves(state), self.pads):
            parts += [x.reshape(-1).view(torch.int32), self.zeros[:pad]]
        return torch.cat(parts)

    def unflatten(self, flat: torch.Tensor) -> dict:
        """The state whose leaves are views of `flat`."""
        views, o = [], 0
        for (shape, dtype), pad in zip(self.specs, self.pads):
            n = shape.numel()
            views.append(flat[o:o + n].view(dtype).view(shape))
            o += n + pad
        return _rebuild(self.like, iter(views))


def stream_layout(model: ActiveBiEAR, batch: int) -> StreamLayout:
    """The model's ``StreamLayout`` for `batch` streams, made once (outside
    inference mode) and kept on the model."""
    cache = model.__dict__.setdefault("_stream_layouts", {})
    if batch not in cache:
        with torch.inference_mode(False):
            cache[batch] = StreamLayout(model, batch)
    return cache[batch]


@torch.inference_mode()
def stream_init(model: ActiveBiEAR, batch: int) -> dict:
    """Fresh state for `batch` concurrent streams, on the model's device
    (views of one new buffer, ``StreamLayout``).

    ``fe`` is the frontend's carry: () for fixed Q, (Q, h, memL, memR) for
    the single controller, the ear-stacked (Q, h) of shape (2, B, ...) for
    the dual one. ``t`` and ``cc.n`` count frames and samples per stream.
    AuralNet is refused: it is not streamable."""
    layout = stream_layout(model, batch)
    return layout.unflatten(layout.fresh.clone())


@torch.inference_mode()
def stream_reset(model: ActiveBiEAR, state: dict, mask) -> dict:
    """Re-initialise the slots where `mask` (B,) is true (a stream ended and
    a new one takes its slot): one masked fill of the flat state against
    the cached fresh state. Reset slots equal a ``stream_init`` slot bit
    for bit; the others are untouched."""
    mask = torch.as_tensor(mask, device=_device(model)).bool()
    layout = stream_layout(model, mask.shape[0])
    return layout.unflatten(torch.where(mask[layout.slot], layout.fresh,
                                        layout.flatten(state)))


# ---------------- CC accumulator ----------------

def _lagged_dots(x: torch.Tensor, ext: torch.Tensor, S: int) -> torch.Tensor:
    """D[b, s] = sum_{m < w} x[b, m] ext[b, s + m] for s in [0, S), with
    x (R, w) and ext (R, >= S - 1 + w).

    A block product instead of S shifted copies: with blocks of P = S
    samples, x[P f + i] meets ext[P f + i + s], so G[i, j] = sum_f
    x[P f + i] E2[f, j] (E2[f] = ext blocks f and f + 1 side by side) holds
    D[s] on the diagonals j = i + s, read at flat stride 2P + 1 after a
    pad. Memory per row: (P, 2P) floats, not (S, w)."""
    R, w = x.shape
    P = S
    nf = -(-w // P)
    xb = F.pad(x, (0, nf * P - w)).reshape(R, nf, P)
    eb = F.pad(ext[:, :nf * P + P], (0, max(0, nf * P + P - ext.shape[1])))
    eb = eb.reshape(R, nf + 1, P)
    e2 = torch.cat([eb[:, :nf], eb[:, 1:]], dim=-1)        # (R, nf, 2P)
    G = torch.bmm(xb.transpose(1, 2), e2)                  # (R, P, 2P)
    Gp = F.pad(G.reshape(R, 2 * P * P), (0, P))
    return Gp.reshape(R, P, 2 * P + 1)[:, :, :S].sum(dim=1)


def _cc_accumulate(cc: dict, chunkL: torch.Tensor, chunkR: torch.Tensor,
                   K: int) -> dict:
    """Fold one chunk (B, w) per ear into the raw-lag accumulator.

    raw[K + l] accumulates sum_m left[m + l] right[m] over the raw signals,
    each pair counted in the chunk that holds its later sample, so only a
    K-sample halo (the tail buffers) is kept: for l >= 0 the chunk's left
    samples meet the halo-extended right signal, for l < 0 the chunk's
    right samples the extended left one, in one ``_lagged_dots`` call."""
    B, w = chunkL.shape
    extL = torch.cat([cc["tailL"], chunkL], dim=1)          # (B, K + w)
    extR = torch.cat([cc["tailR"], chunkR], dim=1)
    D = _lagged_dots(torch.cat([chunkL, chunkR]), torch.cat([extR, extL]),
                     K + 1)
    # l >= 0: D[:B, K - l]; l < 0: D[B:, K + l]
    contrib = torch.cat([D[B:, :K], D[:B].flip(-1)], dim=1)

    first = (cc["n"] == 0)[:, None]
    if w >= K:
        head = lambda old, chunk: torch.where(first, chunk[:, :K], old)
    else:
        # a chunk narrower than K is never the first (stream_plan)
        head = lambda old, chunk: old
    tail = lambda old, chunk: torch.cat([old, chunk], dim=1)[:, -K:]
    return {"raw": cc["raw"] + contrib, "n": cc["n"] + w,
            "sumL": cc["sumL"] + chunkL.sum(dim=1),
            "sumR": cc["sumR"] + chunkR.sum(dim=1),
            "headL": head(cc["headL"], chunkL),
            "headR": head(cc["headR"], chunkR),
            "tailL": tail(cc["tailL"], chunkL),
            "tailR": tail(cc["tailR"], chunkR)}


@constant_cache
def _readout_consts(K: int, device: torch.device) -> tuple:
    """|l| and the mask l >= 0 over the lags -K..K, on `device`."""
    ls = np.arange(-K, K + 1)
    return (torch.as_tensor(np.abs(ls), device=device),
            torch.as_tensor(ls >= 0, device=device)[None, :])


def _cc_readout(cc: dict, plan: dict) -> torch.Tensor:
    """Accumulated raw lags -> the x3 feature (B, num_lags).

    Exact mean removal: with a = |l| and overlap n - a,
      centered[l] = raw[l] - muL S_R(l) - muR S_L(l) + (n - a) muL muR,
    S_R / S_L the raw sums over each lag's overlap (the whole sum minus a
    head or tail edge sum of the first / last K samples). Then the batch
    path's peak normalisation and resampling (``interp_to_lags``)."""
    K = plan["K"]
    n = torch.clamp(cc["n"].float(), min=1.0)
    muL = cc["sumL"] / n
    muR = cc["sumR"] / n
    dev = n.device
    a, pos = _readout_consts(K, dev)
    cum = lambda b: F.pad(torch.cumsum(b, dim=1), (1, 0))
    headL, headR = cum(cc["headL"])[:, a], cum(cc["headR"])[:, a]
    tailL = cum(cc["tailL"].flip(1))[:, a]
    tailR = cum(cc["tailR"].flip(1))[:, a]
    S_R = cc["sumR"][:, None] - torch.where(pos, tailR, headR)
    S_L = cc["sumL"][:, None] - torch.where(pos, headL, tailL)
    centered = (cc["raw"] - muL[:, None] * S_R - muR[:, None] * S_L
                + (n[:, None] - a[None, :]) * (muL * muR)[:, None])
    j0, w, _ = device_lag_plan(plan["fs"], plan["fs"], plan["num_lags"], 3.0,
                               dev)
    return interp_to_lags(centered, j0, w)


# ---------------- per-frame step ----------------

def _frontend_step(model: ActiveBiEAR, c: dict, fe: tuple, chunkL, chunkR):
    """One frame through the model's frontend: a hop (B, win) per ear ->
    (fe', YL, YR, phaseL, phaseR), each output (B, N)."""
    cfg = model.cfg
    if cfg.fixed_frontend_q:
        # (B, 1, F) each
        xs = lambda w: tuple(x[:, None] for x in frame_spectra(cfg, w, c))
        YL, _, phL = fixed_forward(cfg, c, *xs(chunkL))
        YR, _, phR = fixed_forward(cfg, c, *xs(chunkR))
        return fe, YL[:, 0], YR[:, 0], phL[:, 0], phR[:, 0]
    rhs = frame_rhs(cfg, chunkL, chunkR, c)                 # (2B, 4, F)
    fe, (Y, _, phase) = model.bifb.frame(c, model.bifb.filterbank(c), fe,
                                         rhs)
    return fe, Y[0], Y[1], phase[0], phase[1]


def _enc_step(enc, st: dict, x: torch.Tensor) -> dict:
    """One frame through an encoder: in_norm, then the two GRU cells, and
    the running sum of the second one's state (the forward's time mean)."""
    x = enc.in_norm(x)
    h1 = enc.gru1.step(x, st["h1"])
    h2 = enc.gru2.step(h1, st["h2"])
    return {"h1": h1, "h2": h2, "sum": st["sum"] + h2}


def _stream_step(model: ActiveBiEAR, state: dict, chunkL, chunkR) -> dict:
    cfg = model.cfg
    plan = stream_plan(cfg)
    chunkL, chunkR = chunkL.float(), chunkR.float()
    c = device_constants(cfg, chunkL.device)
    with precision_highest():
        fe, YL, YR, phL, phR = _frontend_step(model, c, state["fe"], chunkL,
                                              chunkR)
        x1 = torch.clamp(torch.log(YL + 1e-8), -12.0, 12.0)
        x2 = torch.clamp(torch.log(YR + 1e-8), -12.0, 12.0)
        out = {"t": state["t"] + 1, "fe": fe,
               "ild": _enc_step(model.encoder_ild, state["ild"],
                                ild_features(x1, x2)),
               "ipd": _enc_step(model.encoder_ipd, state["ipd"],
                                ipd_features(phL, phR))}
        if cfg.use_cc:
            out["cc"] = _cc_accumulate(state["cc"], chunkL, chunkR,
                                       plan["K"])
    return out


def _hop(model: ActiveBiEAR, flat: torch.Tensor, chunkL, chunkR):
    """One hop on a flat state (``StreamLayout``), to a flat state."""
    layout = stream_layout(model, chunkL.shape[0])
    return layout.flatten(_stream_step(model, layout.unflatten(flat),
                                       chunkL, chunkR))


@torch.inference_mode()
def stream_step(model: ActiveBiEAR, state: dict, chunkL, chunkR, *,
                capture: bool | None = None) -> dict:
    """Advance every stream by one frame: chunkL / chunkR (B, hop) new
    samples per ear (tensors, or numpy moved to the model's device).
    Returns a new state; `state` is left as it was.

    On a CUDA device the hop replays the model's captured graph for the
    batch and the precision policy (``graph.captured_forward``; JAX's
    ``jax.jit(stream_step)``): the flat state and the chunks are copied
    into its static buffers and the new state is a copy of its output;
    the CPU and ``capture=False`` run it eagerly."""
    if use_capture(model, None, capture):
        layout = stream_layout(model, chunkL.shape[0])
        fwd = captured_forward(model, "stream_step",
                               lambda f, l, r: _hop(model, f, l, r))
        return layout.unflatten(fwd((layout.flatten(state),
                                     host_input(chunkL), host_input(chunkR))))
    dev = _device(model)
    return _stream_step(model, state, torch.as_tensor(chunkL, device=dev),
                        torch.as_tensor(chunkR, device=dev))


@torch.inference_mode()
def stream_readout(model: ActiveBiEAR, state: dict, tailL=None, tailR=None):
    """The current belief: (sound_logits (B, S), aoa (B, S) in [0, 1],
    dist_logits (B, S, C)). tailL / tailR: residual samples that belong to
    no frame (the 1 s protocol leaves fs - T * hop); they update only the
    CC statistics, as the forward correlates the whole crop."""
    cfg = model.cfg
    dev = _device(model)
    plan = stream_plan(cfg)
    with precision_highest():
        cc = state.get("cc")
        if cc is not None and tailL is not None and tailL.shape[1]:
            cc = _cc_accumulate(cc, torch.as_tensor(tailL, device=dev).float(),
                                torch.as_tensor(tailR, device=dev).float(),
                                plan["K"])
        t = torch.clamp(state["t"].float(), min=1.0)[:, None]
        nz = lambda z: torch.nan_to_num(z, nan=0.0, posinf=0.0, neginf=0.0)
        x3 = _cc_readout(cc, plan) if cc is not None else None
        return model.heads(nz(state["ild"]["sum"] / t),
                           nz(state["ipd"]["sum"] / t), x3)


@torch.inference_mode()
def stream_apply(model: ActiveBiEAR, wavL, wavR):
    """A whole (B, fs) crop through the streaming path: T hops in a Python
    loop, then the residual tail at readout. The equivalence harness
    against the model's forward."""
    plan = stream_plan(model.cfg)
    hop, T = plan["hop"], model.cfg.timesteps
    dev = _device(model)
    wavL = torch.as_tensor(wavL, device=dev).float()
    wavR = torch.as_tensor(wavR, device=dev).float()
    state = stream_init(model, wavL.shape[0])
    for t in range(T):
        sl = slice(t * hop, (t + 1) * hop)
        state = stream_step(model, state, wavL[:, sl], wavR[:, sl])
    end = T * hop + plan["tail_len"]
    return stream_readout(model, state, wavL[:, T * hop:end],
                          wavR[:, T * hop:end])
