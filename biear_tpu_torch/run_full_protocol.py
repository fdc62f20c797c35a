#!/usr/bin/env python
"""The full experiment protocol of one arm: train on synthesised speech,
then score two fixed test splits.

    python -m biear_tpu_torch.run_full_protocol --config conf/config.yaml \\
        [--fixed-q] [--corpus speech] [--noise-snr 5,25] \\
        [--train-size 72000] [--eval-size 9000] [--pool-size 256] \\
        [--epochs N] [--batch-size B] [--scene anechoic] \\
        [--fb-w-dtype bfloat16] [--mix-dtype float32] [--seed S] \\
        [--runs-root DIR] [--comments C] [--resume RUN_DIR] [--device cpu]

Counterpart of ``tools/run_full_protocol.py``, with its flags and
defaults (72k train rows per epoch, 9k test rows per split, batch 64,
the config's epochs). Training data comes from the synthesizer on the
device (``train.runner.train`` with SYNTH_ON_DEVICE); the segment pools
are the modulated-noise test segments (``--corpus noise``) or the
source-filter speech corpus (``--corpus speech``, ``data/speech.py``, at
fs + 7 * 128 samples per segment). Pool A (seed + 1) trains and makes
test1, pool B (seed + 9999, unseen speakers) makes test2; each test
split is fixed (seeds + 777 and + 888), one third each of one, two and
three sources. After training, the best checkpoint is scored on both:

    <run>/logs_json/test_metrics.json          the runner's test pass
    <run>/evaluate_biear_metrics_test1.json    overall and per source count
    <run>/evaluate_biear_metrics_test2.json    the same on unseen speakers

The passive family trains on ``PassiveFeatureSynth``'s features of the
synthesised waveforms. It runs on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from .config import is_passive, load_run_config
from .data.passive_synth import PassiveFeatureSynth
from .data.speech import make_speech_pool
from .data.synth import build_synthesizer, make_test_segments
from .device import resolve_device
from .train import state as ckpt
from .train.evaluate import eval_forward
# the JAX tool's name for the evaluator's metrics
from .train.evaluate import metrics_from_predictions as full_metrics
from .train.runner import SynthEvalDataset, _sync, train

TEST_SEEDS = (("test1", 777), ("test2", 888))


@torch.inference_mode()
def predictions_on_device(model, dataset):
    """The eval forward over a ``SynthEvalDataset``'s device batches:
    (sound_logits, aoa, dist_logits, y) as numpy; only these small arrays
    leave the device."""
    model.eval()
    outs = []
    for batch in dataset.device_batches():
        n_in = len(batch) - 1
        s, a, d = eval_forward(model, batch[:n_in])
        outs.append([t.cpu().numpy() for t in (s, a, d, batch[n_in])])
    return tuple(np.concatenate(parts) for parts in zip(*outs))


def make_pools(corpus: str, pool_size: int, fs: int, seed: int):
    """(pool A, pool B) of `corpus`: the speech corpus at fs + 7 * 128
    samples per segment (per-use window offsets within the synthesizer's
    fast path), or the modulated-noise test segments."""
    if corpus == "speech":
        seg_len = fs + 7 * 128
        return tuple(make_speech_pool(pool_size, seg_len=seg_len, fs=fs,
                                      seed=seed + off) for off in (1, 9999))
    return tuple(make_test_segments(pool_size, seed=seed + off)
                 for off in (1, 9999))


def protocol_synth(scene: str, pool, cfg, passive: bool, noise_snr_db=None,
                   mix_dtype: str = "float32", device=None):
    """The scene's synthesizer over `pool` at the model's fs and CC width;
    for the passive family wrapped in ``PassiveFeatureSynth``."""
    synth = build_synthesizer(scene, None, pool, cfg.fs,
                              num_lags=cfg.n_bands, noise_snr_db=noise_snr_db,
                              mix_dtype=mix_dtype, device=device)
    if passive:
        synth = PassiveFeatureSynth(synth, data_dim=cfg.n_bands,
                                    timesteps=cfg.timesteps)
    return synth


def score_splits(model, synths, eval_size: int, seed: int, batch_size: int,
                 run_dir: str, say=print) -> dict:
    """test1 (synths[0]) and test2 (synths[1]): each split made once with
    its protocol seed, scored, and written as
    ``evaluate_biear_metrics_<name>.json`` under run_dir. Returns
    {name: metrics} with the host ms of each split under "ms"."""
    device = next(model.parameters()).device
    out = {"ms": {}}
    for synth, (name, off) in zip(synths, TEST_SEEDS):
        t0 = time.perf_counter()
        ds = SynthEvalDataset(synth, eval_size, seed + off, batch_size,
                              test_thirds=True)
        metrics = full_metrics(*predictions_on_device(model, ds))
        _sync(device)
        out["ms"][name] = 1e3 * (time.perf_counter() - t0)
        with open(os.path.join(run_dir, f"evaluate_biear_metrics_{name}"
                                        ".json"), "w") as f:
            json.dump(metrics, f, indent=2)
        o = metrics["overall"]
        say(f"[{name}] sound_acc={o['sound_acc'] * 100:.2f}% "
            f"aoa_mae={o['aoa_mae']:.4f} ({o['aoa_mae_deg']:.2f} deg, "
            f"masked {o['aoa_mae_deg_masked']:.2f} deg) "
            f"dist_acc={o['dist_acc'] * 100:.2f}%")
        out[name] = metrics
    return out


def parse_snr(text: str | None):
    return tuple(float(x) for x in text.split(",")) if text else None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="conf/config.yaml")
    ap.add_argument("--scene", default="anechoic",
                    choices=("anechoic", "auditorium", "spirit"))
    ap.add_argument("--train-size", type=int, default=72000)
    ap.add_argument("--eval-size", type=int, default=9000)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--fixed-q", action="store_true",
                    help="override FIXED_FRONTEND_Q: true (the ablation)")
    ap.add_argument("--pool-size", type=int, default=256,
                    help="segments per pool")
    ap.add_argument("--corpus", default="noise", choices=("noise", "speech"),
                    help="segment pool: modulated noise, or the "
                         "source-filter speech corpus with disjoint speaker "
                         "sets per pool")
    ap.add_argument("--noise-snr", default=None,
                    help="mix diffuse noise at SNR ~ U[lo,hi] dB, e.g. "
                         "'5,25' (default off)")
    ap.add_argument("--fb-w-dtype", default=None,
                    choices=("float32", "bfloat16"),
                    help="filterbank operand dtype (FB_W_DTYPE)")
    ap.add_argument("--mix-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="anechoic fast-path HRIR-mix operand dtype "
                         "(float32: the window-gather kernel and an f32 "
                         "product; bfloat16: the fused mix kernel)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs-root", default=None)
    ap.add_argument("--comments", default=None)
    ap.add_argument("--resume", default=None, metavar="RUN_DIR",
                    help="continue an interrupted run from its "
                         "checkpoints/last, then score test1 / test2")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)
    say = (lambda *a: None) if args.quiet else print
    device = resolve_device(args.device)

    rc = load_run_config(args.config)
    if args.epochs is not None:
        rc.epochs = args.epochs
    if args.batch_size is not None:
        rc.batch_size = args.batch_size
    if args.fixed_q:
        rc.fixed_frontend_q = True
        rc.model_cfg = dataclasses.replace(rc.model_cfg,
                                           fixed_frontend_q=True)
    if args.fb_w_dtype:
        rc.model_cfg = dataclasses.replace(rc.model_cfg,
                                           fb_w_dtype=args.fb_w_dtype)
        rc.raw["FB_W_DTYPE"] = args.fb_w_dtype
    if args.runs_root:
        rc.runs_root = args.runs_root
    if args.comments is not None:
        rc.comments = args.comments
    rc.synth_on_device = True
    rc.raw = dict(rc.raw,
                  SYNTH_STEPS_PER_EPOCH=max(args.train_size // rc.batch_size,
                                            1),
                  SYNTH_EVAL_SAMPLES=args.eval_size)
    cfg, passive = rc.model_cfg, is_passive(rc)

    t0 = time.perf_counter()
    pool_a, pool_b = make_pools(args.corpus, args.pool_size, cfg.fs,
                                args.seed)
    pool_s = time.perf_counter() - t0
    say(f"[protocol] {args.corpus} pools built: 2 x {args.pool_size} "
        f"segments in {pool_s:.1f} s")
    snr = parse_snr(args.noise_snr)
    synths = [protocol_synth(args.scene, pool, cfg, passive, snr,
                             args.mix_dtype, device)
              for pool in (pool_a, pool_b)]
    say(f"[protocol] {args.train_size} train x {rc.epochs} epochs, "
        f"bs={rc.batch_size}, eval={args.eval_size}, scene={args.scene}, "
        f"model={rc.model_kind}, fixed_q={rc.fixed_frontend_q}, "
        f"ctrl={rc.controller_mode}, corpus={args.corpus}"
        f"(x{args.pool_size}), noise_snr={snr}")
    out = train(rc, synth=synths[0], seed=args.seed, quiet=args.quiet,
                resume_from=args.resume, device=device)
    model, run_dir = out["model"], out["run_dir"]
    best = os.path.join(run_dir, "checkpoints", "best")
    if os.path.isdir(best):
        ckpt.load_checkpoint(best, model)
    scores = score_splits(model, synths, args.eval_size, args.seed,
                          rc.batch_size, run_dir, say)
    say("[protocol] done:", run_dir)
    return {"run_dir": run_dir, "pool_s": pool_s, "history": out["history"],
            "test_ms": scores.pop("ms"), **scores}


if __name__ == "__main__":
    main()
