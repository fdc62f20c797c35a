#!/usr/bin/env python
"""Archive a protocol run's metric files and its best checkpoint.

    python -m biear_tpu_torch.archive_protocol_run RUN_DIR LABEL \\
        [--dest docs/protocol_r3] [--no-checkpoint]

Counterpart of ``tools/archive_protocol_run.py`` for runs of the port
(``run_full_protocol``): DEST/LABEL receives the test1 / test2 metrics,
the runner's ``test_metrics.json``, ``settings.json``, the full
``history.json`` and a ``history_summary.json`` (first and last
validation entries, epoch count), so that results outlive the run
directory. Then ``checkpoints/best`` is exported as ``best.pth``: the
model's state dict alone, under the names of ``models/weights.py`` (the
reference checkpoints' names), checked by loading it strictly into the
model of the run's settings. An AuralNet export carries its attention
weights. A missing or failed export exits with an error, after the
metric files are copied. Host only: nothing runs on a device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import torch

from .config import config_from_settings, family
from .serve.infer import MODELS

METRIC_FILES = ("evaluate_biear_metrics_test1.json",
                "evaluate_biear_metrics_test2.json",
                os.path.join("logs_json", "test_metrics.json"),
                os.path.join("meta", "settings.json"))


def export_best(run_dir: str, out: str) -> str:
    """checkpoints/best/params.pth -> out/best.pth, a state dict that loads
    with strict=True into a fresh model of the run's settings."""
    src = os.path.join(run_dir, "checkpoints", "best", "params.pth")
    if not os.path.isfile(src):
        raise FileNotFoundError(f"no best checkpoint at {src}")
    with open(os.path.join(run_dir, "meta", "settings.json")) as f:
        settings = json.load(f)
    model = MODELS[family(settings)](config_from_settings(settings))
    sd = torch.load(src, map_location="cpu", weights_only=True)
    model.load_state_dict(sd, strict=True)
    dst = os.path.join(out, "best.pth")
    torch.save({k: v.detach().clone() for k, v in model.state_dict().items()},
               dst)
    return dst


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dir")
    ap.add_argument("label")
    ap.add_argument("--dest", default="docs/protocol_r3")
    ap.add_argument("--no-checkpoint", action="store_true",
                    help="skip the best-checkpoint .pth export")
    args = ap.parse_args(argv)

    out = os.path.join(args.dest, args.label)
    os.makedirs(out, exist_ok=True)
    for rel in METRIC_FILES:
        src = os.path.join(args.run_dir, rel)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(out, os.path.basename(rel)))
        else:
            print(f"[archive] missing (skipped): {src}")

    hist_path = os.path.join(args.run_dir, "logs_json", "history.json")
    if os.path.exists(hist_path):
        shutil.copy(hist_path, os.path.join(out, "history.json"))
        with open(hist_path) as f:
            val = json.load(f).get("val", [])
        if val:
            with open(os.path.join(out, "history_summary.json"), "w") as f:
                json.dump({"val_first": val[0], "val_last": val[-1],
                           "epochs": len(val)}, f, indent=1)

    if not args.no_checkpoint:
        print(f"[archive] exported {export_best(args.run_dir, out)}")
    print(f"[archive] wrote {out}")
    return out


if __name__ == "__main__":
    main()
