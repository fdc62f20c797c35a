#!/usr/bin/env python
"""Per-SNR evaluation of trained protocol checkpoints.

    python -m biear_tpu_torch.eval_by_snr RUN_DIR [RUN_DIR ...] \\
        [--snrs 5,10,15,20,25] [--eval-size 4500] [--pool-size 2000] \\
        [--seed 0] [--scene anechoic] [--out F.json] [--device cpu]

Counterpart of ``tools/eval_by_snr.py``: it rebuilds the protocol's
unseen test2 pool (the speech corpus, seed + 9999, split seed + 888) at
each fixed SNR and without noise ("clean"), scores every checkpoint on
every slice and writes one JSON ({"seed", "eval_size", "pool",
"split_seed_offset", "runs": {label: {slice: {sound_acc,
aoa_mae_deg_masked, dist_acc}}}}). A run is a run directory of the
runner (``meta/settings.json``, ``checkpoints/best``) or an archived one
(``settings.json``, ``best.pth``) of a waveform model (active or
AuralNet). It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

from .config import config_from_settings, family
from .data.speech import make_speech_pool
from .device import resolve_device
from .run_full_protocol import (full_metrics, predictions_on_device,
                                protocol_synth)
from .serve.infer import load_model
from .train.runner import SynthEvalDataset


def find_checkpoint(d: str) -> str:
    """best.pth, or the params of checkpoints/best, under `d`."""
    for cand in (os.path.join(d, "best.pth"),
                 os.path.join(d, "checkpoints", "best", "params.pth")):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"no best.pth or checkpoints/best under {d}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dirs", nargs="+",
                    help="run directories or archived ones")
    ap.add_argument("--snrs", default="5,10,15,20,25",
                    help="comma list of fixed SNRs in dB; a clean slice is "
                         "always added")
    ap.add_argument("--eval-size", type=int, default=4500)
    ap.add_argument("--pool-size", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0,
                    help="protocol seed of the runs")
    ap.add_argument("--scene", default="anechoic",
                    choices=("anechoic", "auditorium", "spirit"))
    ap.add_argument("--out", default=None,
                    help="default: docs/protocol_r3/snr_breakdown.json")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)
    say = (lambda *a: None) if args.quiet else print
    device = resolve_device(args.device)
    snrs = [float(s) for s in args.snrs.split(",") if s]

    results: dict = {"seed": args.seed, "eval_size": args.eval_size,
                     "pool": "B (unseen speakers, seed+9999)",
                     "split_seed_offset": 888, "runs": {}}
    models = []
    for d in args.run_dirs:
        sp = os.path.join(d, "meta", "settings.json")
        if not os.path.exists(sp):
            sp = os.path.join(d, "settings.json")
        with open(sp) as f:
            settings = json.load(f)
        cfg = config_from_settings(settings)
        model = load_model(find_checkpoint(d), cfg, device,
                           kind=family(settings))
        label = os.path.basename(os.path.normpath(d))
        models.append((label, settings, cfg, model))
        results["runs"][label] = {}

    bss = {int(s.get("BATCH_SIZE", 64)) for _, s, _, _ in models}
    if len(bss) != 1:
        raise SystemExit(f"runs disagree on BATCH_SIZE ({bss}); the split "
                         "would differ per run: evaluate them separately")
    bs = bss.pop()
    cfg0 = models[0][2]
    pool_b = make_speech_pool(args.pool_size, seg_len=cfg0.fs + 7 * 128,
                              fs=cfg0.fs, seed=args.seed + 9999)
    for snr in snrs + [None]:
        tag = "clean" if snr is None else f"{snr:g}dB"
        # one split per slice, scored by every checkpoint
        synth = protocol_synth(args.scene, pool_b, cfg0, False,
                               None if snr is None else (snr, snr),
                               device=device)
        ds = SynthEvalDataset(synth, args.eval_size, args.seed + 888, bs,
                              test_thirds=True)
        for label, _, _, model in models:
            o = full_metrics(*predictions_on_device(model, ds))["overall"]
            results["runs"][label][tag] = {
                "sound_acc": o["sound_acc"],
                "aoa_mae_deg_masked": o["aoa_mae_deg_masked"],
                "dist_acc": o["dist_acc"]}
            say(f"[{label} @ {tag}] sound_acc={o['sound_acc'] * 100:.2f}% "
                f"masked AoA={o['aoa_mae_deg_masked']:.2f} deg "
                f"dist_acc={o['dist_acc'] * 100:.2f}%")

    out = args.out or os.path.join("docs", "protocol_r3",
                                   "snr_breakdown.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    say("wrote", out)
    return results


if __name__ == "__main__":
    main()
