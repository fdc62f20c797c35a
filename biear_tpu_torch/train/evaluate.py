#!/usr/bin/env python
"""Evaluation: overall and per-source-count metrics of a checkpoint.

Counterpart of ``biear_tpu/train/evaluate.py`` (``evaluate_biear.py``)
for every model family (the active model with dual, single and fixed-Q
frontends, AuralNet, the passive model): the model config and MODEL_KIND
from the run's settings, predictions over a test split in fixed batches
(active and AuralNet: sanitize, then the eval forward on (wavL, wavR,
x3); passive: the eval forward on the five feature planes; the last
batch padded to full with repeated rows, which are dropped), and the
train-identical metric definitions over all N x 8 sectors, overall and
for 1, 2 and 3 sources. A ``.pth`` that lacks a parameter of the model
(the archived AuralNet checkpoints hold no attention weights) raises,
naming the missing keys. The forward runs under the settings'
MATMUL_PRECISION (``device.matmul_precision``), as the run trained.

The checkpoint is a reference-format ``.pth`` or a checkpoint directory of
the port's runner (``<run>/checkpoints/best``, read as its
``params.pth``). Command line (the settings are found as the serving CLI
finds them, walking up to ``meta/settings.json``, or in a
``settings.json`` beside the checkpoint):

    python -m biear_tpu_torch.train.evaluate --checkpoint run/best.pth \\
        --test-shard test.shard [--settings S.json] [--device cpu]

It runs on the card unless ``--device cpu`` is given. The test split is a
``.shard`` file (``data/shard.py``; the card's machine has no ``h5py``):
4 fields (wavL, wavR, x3, y) for the waveform models, 6 (x1, x2, x3, x4,
x5, y) for the passive one.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..config import (config_from_settings, family, is_passive,
                      load_settings_near_checkpoint)
from ..data.pipeline import batch_iterator
from ..device import matmul_precision
from ..data.shard import ShardDataset, shard_shapes
from ..serve.infer import load_model
from ..models.biear import PassiveBiEAR
from ..graph import captured_forward, host_input, use_capture
from .losses import sanitize_wav, sanitize_x3

N_SECTORS = 8


def find_settings(checkpoint_path: str) -> dict | None:
    """meta/settings.json near the checkpoint (as the serving CLI looks),
    else settings.json beside it."""
    s = load_settings_near_checkpoint(checkpoint_path)
    if s is not None:
        return s
    p = os.path.join(os.path.dirname(os.path.abspath(checkpoint_path)),
                     "settings.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return None


def _eval_forward(model, *x):
    if isinstance(model, PassiveBiEAR):
        return model(*(f.float() for f in x))[:3]
    wl, wr = sanitize_wav(x[0], x[1])
    return model(wl, wr, sanitize_x3(x[2]))[:3]


def eval_forward(model, x, *, capture: bool | None = None):
    """(sound_logits, aoa, dist_logits) of the eval forward (the model in
    eval mode) on the input fields `x` of one batch (tensors or numpy
    arrays): the five feature planes of the passive model, or (wavL,
    wavR, x3), sanitised. On a CUDA device it replays the model's
    captured forward per batch signature (JAX's jitted ``step_active`` /
    ``step_passive``); the CPU and ``capture=False`` run it eagerly."""
    if use_capture(model, None, capture):
        fwd = captured_forward(model, "eval_forward",
                               lambda *f: _eval_forward(model, *f))
        return fwd(host_input(f) for f in x)
    device = next(model.parameters()).device
    return _eval_forward(model, *(torch.as_tensor(f, device=device)
                                  for f in x))


@torch.inference_mode()
def collect_predictions(model, ds, batch_size: int, *,
                        capture: bool | None = None):
    """(sound_logits, aoa, dist_logits, y) over the whole split, as numpy,
    from ``eval_forward`` on the model's device (every batch padded to
    full, so one captured graph serves the split)."""
    model.eval()
    outs = []
    for batch in batch_iterator(ds, batch_size, shuffle=False):
        *x, y, w = batch
        s, a, d = eval_forward(model, x, capture=capture)
        valid = w > 0.5
        outs.append([s.cpu().numpy()[valid], a.cpu().numpy()[valid],
                     d.cpu().numpy()[valid], y[valid]])
    return tuple(np.concatenate(parts) for parts in zip(*outs))


def extract_gt_arrays(y_all):
    """GT presence, normalised and degree AoA, distance class; degree AoA
    NaN on empty sectors."""
    N = y_all.shape[0]
    yr = y_all.reshape(N, N_SECTORS, 7)
    sound_gt = yr[:, :, 0]
    aoa_gt_norm = yr[:, :, 1]
    dist_gt = yr[:, :, 2:].argmax(-1).astype(np.int64)
    aoa_gt_deg = np.full((N, N_SECTORS), np.nan, np.float32)
    for k in range(N_SECTORS):
        mask = sound_gt[:, k] > 0.5
        aoa_gt_deg[mask, k] = 45.0 * k + aoa_gt_norm[mask, k] * 45.0
    return sound_gt, aoa_gt_norm, aoa_gt_deg, dist_gt


def extract_pred_arrays(sound_logits, aoa_pred, dist_logits,
                        sound_thresh: float = 0.5):
    """Presence probability, AoA (normalised and degrees, NaN where absent),
    distance class."""
    sound_prob = 1.0 / (1.0 + np.exp(-sound_logits))
    dist_cls = dist_logits.argmax(-1).astype(np.int64)
    N = sound_prob.shape[0]
    aoa_deg = np.full((N, N_SECTORS), np.nan, np.float32)
    for k in range(N_SECTORS):
        mask = sound_prob[:, k] > sound_thresh
        aoa_deg[mask, k] = 45.0 * k + aoa_pred[mask, k] * 45.0
    return sound_prob, aoa_pred.astype(np.float32), aoa_deg, dist_cls


def compute_metrics_like_train(sound_gt, sound_pred, aoa_gt_norm,
                               aoa_pred_norm, dist_gt, dist_pred,
                               aoa_gt_deg=None, aoa_pred_deg=None):
    """All-sector averages, as the train step computes them; with the
    degree arrays also aoa_mae_deg (normalised MAE x 45), the count of
    sectors where GT and prediction are both present and the mean degree
    error over them."""
    sound_acc = np.mean((sound_gt > 0.5) == (sound_pred > 0.5))
    aoa_mae = np.mean(np.abs(aoa_pred_norm.astype(np.float64)
                             - aoa_gt_norm.astype(np.float64)))
    dist_acc = np.mean(dist_pred.flatten() == dist_gt.flatten())
    out = {"sound_acc": float(sound_acc), "aoa_mae": float(aoa_mae),
           "dist_acc": float(dist_acc)}
    if aoa_gt_deg is not None and aoa_pred_deg is not None:
        out["aoa_mae_deg"] = float(aoa_mae * 45.0)
        both = np.isfinite(aoa_gt_deg) & np.isfinite(aoa_pred_deg)
        out["aoa_masked_sectors"] = int(both.sum())
        out["aoa_mae_deg_masked"] = (
            float(np.mean(np.abs(aoa_pred_deg[both] - aoa_gt_deg[both])))
            if both.any() else float("nan"))
    return out


def metrics_from_predictions(s_all, a_all, d_all, y_all) -> dict:
    """{overall, 1spk, 2spk, 3spk} (a source count with no row is left
    out)."""
    sound_gt, aoa_gt_norm, aoa_gt_deg, dist_gt = extract_gt_arrays(y_all)
    sound_pred, aoa_pred_norm, aoa_pred_deg, dist_pred = extract_pred_arrays(
        s_all, a_all, d_all)
    out = {"overall": compute_metrics_like_train(
        sound_gt, sound_pred, aoa_gt_norm, aoa_pred_norm, dist_gt, dist_pred,
        aoa_gt_deg, aoa_pred_deg)}
    n_sources = (sound_gt > 0.5).sum(1)
    for n_src in (1, 2, 3):
        m = n_sources == n_src
        if m.any():
            out[f"{n_src}spk"] = compute_metrics_like_train(
                sound_gt[m], sound_pred[m], aoa_gt_norm[m], aoa_pred_norm[m],
                dist_gt[m], dist_pred[m], aoa_gt_deg[m], aoa_pred_deg[m])
    return out


def evaluate(checkpoint: str, settings: dict | None = None, dataset=None,
             test_shard: str | None = None, batch_size: int = 64,
             out_path: str | None = None, device=None) -> dict:
    """Evaluate a checkpoint of any model family (a reference-format
    ``.pth`` or a runner checkpoint directory) on a test split (`dataset`
    with ``rows()`` / ``len()``, or a ``.shard`` path of the family's
    fields); returns {overall, 1spk, 2spk, 3spk} and writes it as JSON to
    out_path (default: evaluate_biear_metrics.json in the checkpoint's
    parent directory). Runs on the card unless device='cpu'."""
    pth = (os.path.join(checkpoint, "params.pth")
           if os.path.isdir(checkpoint) else checkpoint)
    if settings is None:
        settings = find_settings(pth)
    if settings is None:
        raise ValueError("no meta/settings.json or settings.json near the "
                         "checkpoint; pass settings= explicitly")
    passive = is_passive(settings)
    if dataset is None and test_shard is None:
        raise ValueError("pass dataset= or a .shard test split")
    cfg = config_from_settings(settings)
    model = load_model(pth, cfg, device, kind=family(settings))
    if dataset is None:
        dataset = ShardDataset(test_shard, shapes=shard_shapes(cfg, passive))
    # under the precision policy the run trained with
    with matmul_precision(settings.get("MATMUL_PRECISION", "default")):
        out = metrics_from_predictions(*collect_predictions(model, dataset,
                                                            batch_size))
    if out_path is None:
        out_path = os.path.join(os.path.dirname(os.path.abspath(checkpoint)),
                                "..", "evaluate_biear_metrics.json")
    with open(os.path.abspath(out_path), "w") as f:
        json.dump(out, f, indent=2)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help="reference-format .pth or a runner checkpoint "
                         "directory")
    ap.add_argument("--test-shard", required=True, help="test split .shard")
    ap.add_argument("--settings", default=None,
                    help="settings.json (default: found near the checkpoint)")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--out", default=None,
                    help="metrics JSON (default: evaluate_biear_metrics.json "
                         "in the checkpoint's parent directory)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)
    settings = None
    if args.settings:
        with open(args.settings) as f:
            settings = json.load(f)
    out = evaluate(args.checkpoint, settings=settings,
                   test_shard=args.test_shard, batch_size=args.batch_size,
                   out_path=args.out, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
