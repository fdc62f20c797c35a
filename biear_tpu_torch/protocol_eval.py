#!/usr/bin/env python
"""The test1 / test2 stage of ``run_full_protocol``, on an existing run.

    python -m biear_tpu_torch.protocol_eval RUN_DIR [--checkpoint best] \\
        [--scene anechoic] [--eval-size 9000] [--pool-size 256] [--seed 0] \\
        [--corpus noise] [--noise-snr LO,HI] [--mix-dtype float32] \\
        [--device cpu]

Counterpart of ``tools/protocol_eval.py``: it rebuilds the two pools and
test splits with ``run_full_protocol``'s seeds (pool A seed + 1, pool B
seed + 9999, splits seed + 777 and + 888), scores
``RUN_DIR/checkpoints/<name>`` with the model of the run's
``meta/settings.json`` and writes
``evaluate_biear_metrics_test{1,2}.json`` into the run. The defaults are
those of the JAX tool (the noise corpus, no noise, the f32 mix); given
the flags of a ``run_full_protocol`` call (``--corpus``, ``--noise-snr``,
``--mix-dtype``, ``--pool-size``, ``--eval-size``, ``--seed``), it
reproduces that call's two files. It runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

from .config import config_from_settings, family
from .device import resolve_device
from .run_full_protocol import (make_pools, parse_snr, protocol_synth,
                                score_splits)
from .serve.infer import load_model


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dir")
    ap.add_argument("--checkpoint", default="best",
                    help="checkpoint name under RUN_DIR/checkpoints")
    ap.add_argument("--scene", default="anechoic",
                    choices=("anechoic", "auditorium", "spirit"))
    ap.add_argument("--eval-size", type=int, default=9000)
    ap.add_argument("--pool-size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus", default="noise", choices=("noise", "speech"))
    ap.add_argument("--noise-snr", default=None,
                    help="diffuse noise at SNR ~ U[lo,hi] dB, e.g. '5,25'")
    ap.add_argument("--mix-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)
    say = (lambda *a: None) if args.quiet else print
    device = resolve_device(args.device)

    with open(os.path.join(args.run_dir, "meta", "settings.json")) as f:
        settings = json.load(f)
    cfg, kind = config_from_settings(settings), family(settings)
    pth = os.path.join(args.run_dir, "checkpoints", args.checkpoint,
                       "params.pth")
    model = load_model(pth, cfg, device, kind=kind)
    say(f"[protocol-eval] {args.run_dir} ({kind}), checkpoint="
        f"{args.checkpoint}, scene={args.scene}, corpus={args.corpus}")
    snr = parse_snr(args.noise_snr)
    synths = [protocol_synth(args.scene, pool, cfg, kind == "passive", snr,
                             args.mix_dtype, device)
              for pool in make_pools(args.corpus, args.pool_size, cfg.fs,
                                     args.seed)]
    return score_splits(model, synths, args.eval_size, args.seed,
                        int(settings.get("BATCH_SIZE", 64)), args.run_dir,
                        say)


if __name__ == "__main__":
    main()
