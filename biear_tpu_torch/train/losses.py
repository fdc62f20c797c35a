"""Losses, train-time metrics and input sanitisation.

Counterpart of ``biear_tpu/train/losses.py``: the target unpacking, the
weighted loss trio (BCE with pos_weight 3 on presence, smooth L1 with
beta 0.02 on AoA, cross-entropy on distance), the Q regularisers, and the
input hygiene shared with serving. Every function takes optional
per-sample weights ``w`` (B,): zero-weight rows (padding) count for
nothing. Nothing syncs with the host.
"""

from __future__ import annotations

import torch


def unpack_targets(y: torch.Tensor, n_sectors: int = 8,
                   n_dist_class: int = 5):
    """y (B, 56) -> (y_sound (B, 8), y_aoa (B, 8), y_dist (B, 8, C)): per
    sector k the slice [sound, aoa, onehot] at offset (2 + C) k."""
    y = y.reshape(y.shape[0], n_sectors, 2 + n_dist_class)
    return y[:, :, 0], y[:, :, 1], y[:, :, 2:]


def batch_mean(x: torch.Tensor, w: torch.Tensor | None = None):
    """Mean over all elements of x (B, ...), or weighted by w (B,): the
    weighted sum over max(sum w, 1e-8) times the elements per row."""
    if w is None:
        return torch.mean(x)
    wx = w.reshape(w.shape[0], *([1] * (x.ndim - 1)))
    denom = torch.clamp(torch.sum(w), min=1e-8) * (x.numel() // x.shape[0])
    return torch.sum(x * wx) / denom


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def bce_pos_weight(logits, targets, pos_weight: float = 3.0, w=None):
    """BCEWithLogitsLoss(pos_weight) mean, computed stably:
    l = pw * y * softplus(-x) + (1 - y) * softplus(x)."""
    l = (pos_weight * targets * _softplus(-logits)
         + (1.0 - targets) * _softplus(logits))
    return batch_mean(l, w)


def smooth_l1(pred, target, beta: float = 0.02, w=None):
    """SmoothL1Loss(beta) mean."""
    d = torch.abs(pred - target)
    return batch_mean(torch.where(d < beta, 0.5 * d * d / beta,
                                  d - 0.5 * beta), w)


def cross_entropy(logits, target_idx, w=None):
    """Mean CE over integer class targets (logits (B, S, C) or (M, C))."""
    logp = torch.log_softmax(logits, dim=-1)
    l = -torch.gather(logp, -1, target_idx[..., None])[..., 0]
    return batch_mean(l, w)


def task_loss(sound_logits, aoa_pred, dist_logits, y,
              w_sound: float = 0.2, w_aoa: float = 0.45, w_dist: float = 0.35,
              n_dist_class: int = 5, w=None):
    """Weighted task loss and train-time metrics (tensors on the device):
    (loss, {"loss", "sound_acc", "aoa_mae", "dist_acc"})."""
    y_sound, y_aoa, y_dist = unpack_targets(y, sound_logits.shape[1],
                                            n_dist_class)
    dist_target = torch.argmax(y_dist, dim=-1)               # (B, S)
    loss_sound = bce_pos_weight(sound_logits, y_sound, w=w)
    loss_aoa = smooth_l1(aoa_pred, y_aoa, w=w)
    loss_dist = cross_entropy(dist_logits, dist_target, w=w)
    loss = w_sound * loss_sound + w_aoa * loss_aoa + w_dist * loss_dist
    with torch.no_grad():
        sound_acc = batch_mean(((torch.sigmoid(sound_logits) > 0.5)
                                == (y_sound > 0.5)).float(), w)
        aoa_mae = batch_mean(torch.abs(aoa_pred - y_aoa), w)
        dist_acc = batch_mean((torch.argmax(dist_logits, dim=-1)
                               == dist_target).float(), w)
    return loss, {"loss": loss.detach(), "sound_acc": sound_acc,
                  "aoa_mae": aoa_mae, "dist_acc": dist_acc}


def q_regularizers(Q, Q0, reg_q_w: float, reg_smooth_w: float, w=None):
    """log-Q deviation from Q0 plus band smoothness: Q (B, T, N), Q0 (N,)."""
    logQ = torch.log(Q + 1e-8)
    logQ0 = torch.log(Q0 + 1e-8)[None, None, :]
    reg_q = batch_mean((logQ - logQ0) ** 2, w)
    reg_smooth = batch_mean((logQ[:, :, 1:] - logQ[:, :, :-1]) ** 2, w)
    return reg_q_w * reg_q + reg_smooth_w * reg_smooth


def sanitize_x3(x3: torch.Tensor) -> torch.Tensor:
    """nan -> 0, per-sample peak-normalise (floor 1), clamp +-5."""
    x3 = torch.nan_to_num(x3.float(), nan=0.0, posinf=0.0, neginf=0.0)
    scale = torch.clamp(x3.abs().amax(dim=1, keepdim=True), min=1.0)
    return torch.clamp(x3 / scale, -5.0, 5.0)


def sanitize_wav(wavL: torch.Tensor, wavR: torch.Tensor):
    """int16 heuristic, then clamp +-1: if the largest |sample| of the
    WHOLE batch (both ears) exceeds 2, every sample is divided by 32768.
    Decided on the device, without a host sync."""
    wavL, wavR = wavL.float(), wavR.float()
    maxabs = torch.maximum(wavL.abs().amax(), wavR.abs().amax())
    scale = torch.where(maxabs > 2.0, 1.0 / 32768.0, 1.0)
    return (torch.clamp(wavL * scale, -1.0, 1.0),
            torch.clamp(wavR * scale, -1.0, 1.0))
