#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``biear_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then not 0):

  1. device: a CUDA card is required; its name and power limit are printed.
  2. build: every CUDA kernel of the serving path is compiled from the
     sources in this checkout (kernels/cc_lags.cu).
  3. kernel vs plain: each kernel is held against its plain PyTorch version
     on the card (TF32 off) at the serving shapes, and timed.
  4. serve: the flagship dual-controller adaptive-Q model at full width,
     seeded random weights, through ``serve.infer.predict`` at batch 1, 64
     and 512 under the bf16 policy and at batch 64 under the f32 policy.
     The launch counts are zeroed just before and read just after; each
     kernel of the path must have launched. Then the outputs are checked
     (shapes, finite, probabilities in [0, 1], Q adapting, the CUDA CC
     against the plain CC end to end, the card against the CPU on a small
     batch) and batch-512 throughput is timed.

Prints, before the last line, the card line of nvidia-smi and one JSON
line {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

H100_F32_FLOPS = 67e12        # non-tensor-core f32, H100 SXM data sheet
H100_HBM_BYTES_S = 3.35e12    # HBM3, H100 SXM data sheet
CC_RTOL, CC_ATOL = 2e-5, 2e-4
FLAGSHIP = dict(controller_mode="dual", deltaQ_mode="relative",
                deltaQ_base=1.0, deltaQ_low_factor=0.3, deltaQ_high_factor=5.0)
SERVE_BATCHES = ((1, "bfloat16"), (64, "bfloat16"), (512, "bfloat16"),
                 (64, "float32"))


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(fn, reps: int = 7, inner: int = 10) -> float:
    """Median over `reps` of the CUDA-event time of `inner` calls, per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_kernels(torch, rng):
    """Build cc_lags.cu, hold it against the plain version, time both."""
    from biear_tpu_torch.device import no_tf32
    from biear_tpu_torch.kernels.build import cc_lags_lib
    from biear_tpu_torch.ops.window_gather import cc_kept_lags_cuda
    from biear_tpu_torch.ops.xcorr import cc_kept_lags_plain

    t0 = time.perf_counter()
    cc_lags_lib()
    log(f"build cc_lags.cu: {time.perf_counter() - t0:.1f} s")

    max_err = 0.0
    timing = None
    with no_tf32():
        for B, n, K in ((512, 16000, 48), (1, 16000, 48), (7, 1024, 63)):
            lf = torch.tensor(rng.standard_normal((B, n)), dtype=torch.float32,
                              device="cuda")
            rf = torch.tensor(rng.standard_normal((B, n)), dtype=torch.float32,
                              device="cuda")
            got = cc_kept_lags_cuda(lf, rf, K)
            want = cc_kept_lags_plain(lf, rf, K)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=CC_RTOL, atol=CC_ATOL)
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            log(f"cc_lags B={B} n={n} K={K}: max |kernel - plain| = {err!r}")
            if timing is None:           # the serving shape
                timing = cc_timing(torch, lf, rf, K)
    return max_err, timing


def cc_timing(torch, lf, rf, K):
    """Kernel, plain and one-library-call times at the serving shape, and
    the card's bound for the same work."""
    import torch.nn.functional as F
    from biear_tpu_torch.ops.window_gather import cc_kept_lags_cuda
    from biear_tpu_torch.ops.xcorr import cc_kept_lags_plain

    B, n = lf.shape
    lags = 2 * K + 1
    # one grouped cross-correlation: out[b, s] = sum_m lfpad[b, s+m] rf[b, m]
    lfp, w = F.pad(lf, (K, K))[None], rf[:, None]
    lib = lambda: F.conv1d(lfp, w, groups=B)
    # same function; cuDNN may pick an FFT or Winograd algorithm, whose
    # rounding (measured 1.6e-3 on sums of ~1e2) is looser than the kernel's
    torch.testing.assert_close(lib()[0], cc_kept_lags_plain(lf, rf, K),
                               rtol=1e-4, atol=1e-2)
    flops = 2.0 * B * n * lags
    nbytes = 4.0 * (2 * B * n + B * lags)
    t_ops, t_bytes = flops / H100_F32_FLOPS, nbytes / H100_HBM_BYTES_S
    return {
        "ms": cuda_ms(lambda: cc_kept_lags_cuda(lf, rf, K)),
        "plain_ms": cuda_ms(lambda: cc_kept_lags_plain(lf, rf, K)),
        "library_ms": cuda_ms(lib),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def predict_plain_cc(torch, model, wavL, wavR):
    """predict's composition with the plain CC in place of the kernel."""
    from biear_tpu_torch.ops.xcorr import (cc_kept_lags_plain, interp_to_lags,
                                           lag_plan)
    from biear_tpu_torch.train.losses import sanitize_wav, sanitize_x3
    cfg = model.cfg
    with torch.inference_mode():
        wavL, wavR = sanitize_wav(wavL, wavR)
        kept, j0, w = lag_plan(wavL.shape[1], cfg.fs, cfg.n_bands, 3.0)
        lf = wavL - wavL.mean(-1, keepdim=True)
        rf = wavR - wavR.mean(-1, keepdim=True)
        cc = cc_kept_lags_plain(lf, rf, int(np.abs(kept).max()))
        x3 = sanitize_x3(interp_to_lags(cc, j0, w))
        sound, aoa, dist, _ = model(wavL, wavR, x3)
        return torch.sigmoid(sound), aoa, torch.softmax(dist, -1)


def perturb_controllers(torch, model, seed: int):
    """Non-zero controller output layers (seeded), so Q really moves."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for ctrl in (model.bifb.fb_L, model.bifb.fb_R):
            for p in (ctrl.q_out[8].weight, ctrl.q_out[8].bias):
                p.copy_(torch.rand(p.shape, generator=gen) * 0.1 - 0.05)


def check_outputs(torch, out, B):
    probs, aoa, dist = out
    shapes = tuple(tuple(a.shape) for a in out)
    if shapes != ((B, 8), (B, 8), (B, 8, 5)):
        raise RuntimeError(f"B={B}: output shapes {shapes}")
    for name, a in (("present", probs), ("aoa", aoa), ("dist", dist)):
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"B={B} {name}: nonfinite output")
        if not (0.0 <= float(a.min()) and float(a.max()) <= 1.0):
            raise RuntimeError(f"B={B} {name}: outside [0, 1]")
    torch.testing.assert_close(dist.sum(-1), torch.ones_like(dist[..., 0]),
                               rtol=0, atol=1e-5)


def phase_serve(torch, rng):
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.serve.infer import predict

    models = {}
    for dt in ("bfloat16", "float32"):
        m = build_active(BiEARConfig(**FLAGSHIP, fb_w_dtype=dt), seed=0)
        perturb_controllers(torch, m, seed=1)
        models[dt] = m
    wav = {B: [torch.tensor(rng.uniform(-1, 1, (B, 16000)),
                            dtype=torch.float32, device="cuda")
               for _ in range(2)] for B in (1, 64, 512)}

    LAUNCHES.clear()
    outs = {(B, dt): predict(models[dt], *wav[B]) for B, dt in SERVE_BATCHES}
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"serving path launches: {launches}")
    if launches.get("cc_lags", 0) != len(SERVE_BATCHES):
        raise RuntimeError(f"cc_lags launched {launches.get('cc_lags', 0)} "
                           f"times for {len(SERVE_BATCHES)} served batches")

    for (B, dt), out in outs.items():
        check_outputs(torch, out, B)
        log(f"serve B={B} {dt}: shapes and ranges ok")

    model = models["bfloat16"]
    with torch.inference_mode():
        _, _, _, aux = model(*wav[64])
    Q0 = aux["Q"][:, :1]
    q_move = float((aux["Q"][:, 1:] - Q0).abs().max())
    log(f"max |Q(t) - Q(0)| at B=64: {q_move!r}")
    if not q_move > 1e-4:
        raise RuntimeError("the controllers do not move Q")

    plain = predict_plain_cc(torch, model, *wav[512])
    err = max(float((a - b).abs().max())
              for a, b in zip(outs[(512, "bfloat16")], plain))
    log(f"B=512 CUDA CC vs plain CC, end to end: max abs diff {err!r}")
    if not err <= 1e-4:
        raise RuntimeError(f"CUDA-CC forward differs from plain-CC: {err}")

    # the card against the CPU run of the same port (held against the JAX
    # package by the CPU tests), on a small batch
    for dt, tol in (("float32", 2e-3), ("bfloat16", 2e-2)):
        cpu_model = build_active(models[dt].cfg, seed=0, device="cpu")
        cpu_model.load_state_dict(models[dt].state_dict())
        wl, wr = (w[:4] for w in wav[64])
        gpu_out = predict(models[dt], wl, wr)
        cpu_out = predict(cpu_model, wl.cpu(), wr.cpu())
        d = max(float((g.cpu() - c).abs().max())
                for g, c in zip(gpu_out, cpu_out))
        log(f"B=4 {dt}: max |card - CPU| = {d!r} (tolerance {tol})")
        if not d <= tol:
            raise RuntimeError(f"{dt}: card and CPU differ by {d}")

    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict(model, *wav[512])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t = statistics.median(times[1:])
    log(f"serve B=512 bf16: median {t * 1e3!r} ms per batch, "
        f"{512 / t!r} utterances/s")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import biear_tpu_torch  # noqa: F401  (fails outside a checkout)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {smi}")

    rng = np.random.default_rng(0)
    max_err, timing = phase_kernels(torch, rng)
    launches = phase_serve(torch, rng)

    kernels = [dict(name="cc_lags", route="cuda",
                    source="biear_tpu_torch/kernels/cc_lags.cu",
                    replaces="biear_tpu/ops/window_gather.py:250",
                    status="ported", launches=launches["cc_lags"],
                    max_abs_err=max_err, **timing)]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
