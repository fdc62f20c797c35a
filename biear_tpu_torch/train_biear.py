#!/usr/bin/env python
"""Train a BiEAR model with the PyTorch port.

    python -m biear_tpu_torch.train_biear --config conf/config.yaml \\
        [--epochs N] [--max-steps-per-epoch N] [--seed S] \\
        [--resume RUN_DIR] [--quiet] [--device cpu]

Counterpart of ``train_biear.py``: it reads the run config, trains under
RUNS_ROOT with the same run tree, settings.json, history.json and
checkpoint names (``train.runner.train``), and with SYNTH_ON_DEVICE: true
synthesises the training data on the device (SOFA_FILE, SEGMENT_POOL,
SCENE: anechoic, auditorium or spirit; the passive family's features are
computed from the synthesised waveforms). It runs on the card unless
``--device cpu`` is given.

Over N GPUs of one machine, one process per GPU, with MESH_DATA x
MESH_MODEL = N in the config (MESH_DATA: -1 takes N / MESH_MODEL):

    torchrun --standalone --nproc_per_node N \
        -m biear_tpu_torch.train_biear --config conf/config.yaml

Under torchrun (RANK and WORLD_SIZE set) each process joins the process
group (NCCL on the card, gloo with ``--device cpu``) before training, and
rank 0 alone writes the run tree.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .config import RunConfig, is_passive, load_run_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_synth(rc: RunConfig, device=None):
    """The run config's on-device synthesizer: SCENE (anechoic, auditorium
    or spirit; 'room' is auditorium), SOFA_FILE (the scene's built-in test
    bank when unset or missing) and SEGMENT_POOL (.npy; 64 test segments
    when unset), under the f32 mix, as ``train_biear.py`` builds it; for
    the passive family wrapped in ``PassiveFeatureSynth``."""
    from .data.passive_synth import PassiveFeatureSynth
    from .data.synth import build_synthesizer, make_test_segments

    sofa = rc.raw.get("SOFA_FILE")
    segs_npy = rc.raw.get("SEGMENT_POOL")
    scene = str(rc.raw.get("SCENE", "anechoic")).lower()
    scene = "auditorium" if scene == "room" else scene
    segments = np.load(segs_npy) if segs_npy else make_test_segments(64)
    if sofa and not os.path.exists(sofa):
        print(f"[Scene] SOFA_FILE {sofa!r} not found; "
              f"using the built-in {scene} test bank")
        sofa = None
    synth = build_synthesizer(scene, sofa, segments, rc.model_cfg.fs,
                              num_lags=rc.model_cfg.n_bands, device=device)
    if is_passive(rc):
        synth = PassiveFeatureSynth(synth, data_dim=rc.model_cfg.n_bands,
                                    timesteps=rc.model_cfg.timesteps)
    return synth


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join(REPO, "conf",
                                                     "config.yaml"))
    ap.add_argument("--epochs", type=int, default=None,
                    help="override EPOCHS")
    ap.add_argument("--max-steps-per-epoch", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", default=None, metavar="RUN_DIR",
                    help="continue training from an existing run directory "
                         "(parameters, optimizer state and epoch)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    from .device import resolve_device
    from .parallel.mesh import init_distributed, is_main
    from .train.runner import train

    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    device = (init_distributed(args.device) if launched
              else resolve_device(args.device))
    rc = load_run_config(args.config)
    if args.epochs is not None:
        rc.epochs = args.epochs
    synth = make_synth(rc, device) if rc.synth_on_device else None
    out = train(rc, synth=synth, seed=args.seed, quiet=args.quiet,
                max_steps_per_epoch=args.max_steps_per_epoch,
                resume_from=args.resume, device=device)
    if is_main():
        print("Training finished.")
        print("[Run dir]", out["run_dir"])
    if launched:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
