#!/usr/bin/env python3
"""Batch-size sweep of the training operating point on the card: the
counterpart of ``tools/bench_batch_sweep.py``.

    python -m biear_tpu_torch.bench_batch_sweep [--batches 256,512,1024,2048]
        [--out docs/torch_batch_sweep.json] [--f32-parity]
        [--fb-vjp custom|autodiff] [--matmul-precision NAME]

At each batch: the bare train step and the fused synthesize -> train
chunk of ``bench.py``'s flagship, with ``biear_tpu_torch.bench``'s
methodology (windows ended by ``torch.cuda.synchronize()``, median of
WINDOWS; step: STEPS steps per window; fused: CHUNK_DISPATCHES chunks of
CHUNK steps; both replay captured CUDA graphs, ``train/graph.py``), and
the peak device memory of both. ``--fb-vjp`` sets
``BiEARConfig.fb_vjp`` (the filterbank backward); ``--matmul-precision``
runs the sweep under that MATMUL_PRECISION (``device.matmul_precision``).
Writes one JSON with a row per batch; a file whose ``device`` names a TPU
(the JAX tool's ``docs/batch_sweep.json``) is never overwritten.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch

from .bench import (CHUNK, CHUNK_DISPATCHES, SEGMENTS, STEPS, WINDOWS,
                    bare_step_rates, flagship_config, fused_rates,
                    power_limit)
from .device import matmul_precision, matmul_precision_name, resolve_device
from .models import BiEARConfig
from .train.optim import TrainHyper


def measure_batch(cfg: BiEARConfig, batch: int, mix_dtype: str, device,
                  chunk: int = CHUNK, steps: int = STEPS,
                  dispatches: int = CHUNK_DISPATCHES,
                  windows: int = WINDOWS, segments: int = SEGMENTS) -> dict:
    """One row: bare-step and fused utt/s and ms per step at `batch`."""
    device = resolve_device(device)
    hp = TrainHyper()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step = bare_step_rates(cfg, hp, batch, steps, windows, device)
    fused = fused_rates(cfg, hp, batch, chunk, dispatches, windows,
                        mix_dtype, device, segments)
    step_med, fused_med = statistics.median(step), statistics.median(fused)
    return {
        "batch": batch,
        "step_utt_s": round(step_med, 1),
        "step_ms": round(1e3 * batch / step_med, 2),
        "step_windows": [round(r, 1) for r in step],
        "fused_utt_s": round(fused_med, 1),
        "fused_step_ms": round(1e3 * batch / fused_med, 2),
        "fused_windows": [round(r, 1) for r in fused],
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
    }


def sweep(cfg: BiEARConfig, batches, mix_dtype: str, device=None,
          **kw) -> dict:
    """The sweep's JSON: the policy, the card and one row per batch (`kw`:
    ``measure_batch``'s window sizes)."""
    device = resolve_device(device)
    rows = []
    for b in batches:
        rows.append(measure_batch(cfg, b, mix_dtype, device, **kw))
        print(json.dumps(rows[-1]), file=sys.stderr)
    windows = kw.get("windows", WINDOWS)
    return {
        "fb_w_dtype": cfg.fb_w_dtype,
        "synth_mix_dtype": mix_dtype,
        "fb_vjp": cfg.fb_vjp,
        "matmul_precision": matmul_precision_name(),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "power_limit": power_limit(device),
        "methodology": (
            f"synchronized windows (median of {windows}); step: "
            f"{kw.get('steps', STEPS)} steps/window; fused: "
            f"{kw.get('dispatches', CHUNK_DISPATCHES)} x "
            f"{kw.get('chunk', CHUNK)}-step chunks"),
        "rows": rows,
    }


def refuse_tpu_file(path: str) -> None:
    """SystemExit when `path` holds a sweep measured on a TPU."""
    if not os.path.exists(path):
        return
    with open(path) as f:
        device = str(json.load(f).get("device", ""))
    if "TPU" in device.upper():
        raise SystemExit(f"{path} holds a TPU sweep ({device!r}); write "
                         "the card's elsewhere")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="256,512,1024,2048")
    ap.add_argument("--out", default="docs/torch_batch_sweep.json")
    ap.add_argument("--f32-parity", action="store_true")
    ap.add_argument("--fb-vjp", default="custom",
                    choices=("custom", "autodiff"))
    ap.add_argument("--matmul-precision", default="default")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)
    refuse_tpu_file(args.out)
    dtype = "float32" if args.f32_parity else "bfloat16"
    cfg = flagship_config(dtype, fb_vjp=args.fb_vjp)
    batches = [int(x) for x in args.batches.split(",") if x]
    with matmul_precision(args.matmul_precision):
        out = sweep(cfg, batches, dtype, args.device)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"wrote": args.out, "rows": len(out["rows"])}))


if __name__ == "__main__":
    main()
