#!/usr/bin/env python3
"""Where the serving time goes on the card: per-stage times and a kernel
breakdown of ``serve.infer.predict`` for the flagship model, the
single-controller one or AuralNet.

    python -m biear_tpu_torch.serve.profile_serve [--batch 512]
        [--controller-mode dual|single] [--model active|auralnet]
        [--out f.json]

``--controller-mode`` picks the active model's geometry (``GEOMETRY``):
"dual" the flagship of ``bench.py:100-102``, "single" that of
``conf/config_single_ctrl.yaml`` (one shared controller, absolute deltaQ,
base 2.0, low 0.5, high 5); ``--model auralnet`` serves AuralNet at
``conf/config_auralnet_deepear.yaml``'s width (``AURALNET``). Stages are
timed with CUDA events (median of repeated runs): the CC feature
(sanitize + correlation + resample), the frame spectra of both ears, the
whole frontend (spectra included; the active model's 19 frames of
filterbank and controllers, AuralNet's fixed filterbank and log), the
backend (the active model's encoders, or AuralNet's three attention
blocks; then body and heads) and the whole ``predict``. Then
``torch.profiler`` traces a few ``predict`` calls: the device time summed
by kernel name, the device's idle share of the traced wall time and the
host's launches per call. ``predict`` is the path users get, one captured
CUDA graph per call (its warm-up and capture ms and pool bytes are
reported under "graphs"). Seeded random weights; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..device import precision_highest
from ..graph import pool_stats
from ..models import AuralNet, BiEARConfig, build_active, build_auralnet
from ..models.backend import ild_features, ipd_features
from ..models.frontend import auralnet_fb, device_constants, spectra
from ..ops.xcorr import cross_correlation_feature
from ..train.losses import sanitize_wav, sanitize_x3
from .infer import predict

FLAGSHIP = dict(controller_mode="dual", deltaQ_mode="relative",
                deltaQ_base=1.0, deltaQ_low_factor=0.3, deltaQ_high_factor=5.0)
SINGLE_CTRL = dict(controller_mode="single", deltaQ_mode="absolute",
                   deltaQ_base=2.0, deltaQ_low_factor=0.5,
                   deltaQ_high_factor=5.0)
GEOMETRY = {"dual": FLAGSHIP, "single": SINGLE_CTRL}
# conf/config_auralnet_deepear.yaml: the fixed-Q filterbank at Q0
AURALNET = dict(fixed_frontend_q=True, controller_mode="dual",
                deltaQ_mode="absolute", deltaQ_base=2.0,
                deltaQ_low_factor=0.5, deltaQ_high_factor=1.0)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of one call, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 10) -> list:
    """Host-clock times of `reps` synchronised calls, in ms."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _stages(model, wl, wr, x3, c):
    """(frontend, backend) closures of the model's forward on sanitised
    waveforms and x3."""
    cfg = model.cfg
    if isinstance(model, AuralNet):
        def frontend():
            return [torch.clamp(torch.log(auralnet_fb(cfg, w, c) + 1e-8),
                                -12.0, 12.0) for w in (wl, wr)]
        xL, xR = frontend()

        def backend():
            z = [blk(x).mean(dim=1) for blk, x in (
                (model.attn_L, xL), (model.attn_R, xR),
                (model.attn_diff, xL - xR))]
            z.append(model.cc_proj(x3))
            return model.subheads(model.body(torch.cat(z, -1)))
        return frontend, backend

    fe = model.bifb(wl, wr)

    def backend():
        YL, YR, _, _, phL, phR = fe
        x1 = torch.clamp(torch.log(YL + 1e-8), -12.0, 12.0)
        x2 = torch.clamp(torch.log(YR + 1e-8), -12.0, 12.0)
        return model.heads(model.encoder_ild(ild_features(x1, x2)),
                           model.encoder_ipd(ipd_features(phL, phR)), x3)
    return (lambda: model.bifb(wl, wr)), backend


def stage_times(model, wavL, wavR) -> dict:
    cfg = model.cfg
    c = device_constants(cfg, wavL.device)
    with torch.inference_mode(), precision_highest():
        wl, wr = sanitize_wav(wavL, wavR)
        x3 = sanitize_x3(cross_correlation_feature(wl, wr, cfg.fs,
                                                   num_lags=cfg.n_bands))
        frontend, backend = _stages(model, wl, wr, x3, c)

        return {
            "cc_feature_ms": cuda_ms(lambda: sanitize_x3(
                cross_correlation_feature(wl, wr, cfg.fs,
                                          num_lags=cfg.n_bands))),
            "spectra_both_ears_ms": cuda_ms(
                lambda: (spectra(cfg, wl, c), spectra(cfg, wr, c))),
            "frontend_ms": cuda_ms(frontend),
            "backend_ms": cuda_ms(backend),
            "predict_ms": cuda_ms(lambda: predict(model, wavL, wavR)),
            "predict_host_ms_runs": host_ms(
                lambda: predict(model, wavL, wavR)),
        }


# the CUDA API calls that put work on a stream from the host
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def device_profile(fn, calls: int = 3, top: int = 15) -> dict:
    """Device time by kernel over `calls` traced calls of fn (after one
    untraced call), the share of the traced wall time in which no kernel
    ran (one stream, so kernel times do not overlap), and the host's calls
    that enqueue work (kernel and graph launches, async copies and
    fills) per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    rows = [(e.key, e.device_time_total / calls / 1e3, e.count // calls)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in HOST_LAUNCH_CALLS) / calls
    return {
        "wall_ms_per_call": wall_ms,
        "device_busy_ms_per_call": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "kernels_per_call": sum(r[2] for r in rows),
        "host_launches_per_call": launches,
        "top": [{"name": k[:90], "ms_per_call": ms, "launches_per_call": n}
                for k, ms, n in rows[:top]],
    }


def kernel_breakdown(model, wavL, wavR, calls: int = 3, top: int = 15):
    """device_profile of ``predict`` on one batch."""
    return device_profile(lambda: predict(model, wavL, wavR), calls, top)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--policy", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--controller-mode", default="dual",
                    choices=tuple(GEOMETRY))
    ap.add_argument("--model", default="active",
                    choices=("active", "auralnet"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA card")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    if args.model == "auralnet":
        model = build_auralnet(BiEARConfig(**AURALNET,
                                           fb_w_dtype=args.policy),
                               seed=args.seed)
    else:
        model = build_active(BiEARConfig(**GEOMETRY[args.controller_mode],
                                         fb_w_dtype=args.policy),
                             seed=args.seed)
    rng = np.random.default_rng(args.seed)
    wavL, wavR = (torch.tensor(rng.uniform(-1, 1, (args.batch, 16000)),
                               dtype=torch.float32, device="cuda")
                  for _ in range(2))
    result = {"card": smi, "batch": args.batch, "policy": args.policy,
              "model": args.model, "controller_mode": args.controller_mode,
              "stages": stage_times(model, wavL, wavR),
              "profile": kernel_breakdown(model, wavL, wavR),
              "graphs": pool_stats(model)}
    runs = sorted(result["stages"]["predict_host_ms_runs"])
    result["predict_host_ms_median"] = statistics.median(runs)
    result["utterances_per_s"] = args.batch * 1e3 / statistics.median(runs)
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
