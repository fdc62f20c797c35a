#!/usr/bin/env python3
"""Probe: the frame spectra as DFT products against the rFFT on the card,
the counterpart of ``tools/probe_dft_matmul.py``.

    python -m biear_tpu_torch.probe_dft_matmul [--batch 1024] [--iters 50]
        [--out docs/torch_dft_matmul_probe.json] [--device cpu]

The frontends' spectra (``models/frontend.py::spectra``) are the rFFT of
(B, T, 842) Hann-windowed frames zero-padded to 1024, or, under the bf16
policy's ``dft_mode`` "auto", two (842, 513) products with the windowed
DFT bases. Variants, on synthesised waveforms (three modulated tones and
noise; batch 1024 = both ears of batch 512):

  * ``rfft``: ``spectra`` with dft_mode "fft" (cuFFT), the reference;
  * ``dft_f32``: ``spectra`` with dft_mode "matmul", what the model runs
    (f32 products, TF32 off under every MATMUL_PRECISION; (B, T, W)
    frames times a (W, F) basis, which torch runs as a batched product
    of T rows per utterance);
  * ``dft_f32_flat``: the same products on the frames flattened to one
    (B T, W) operand, one product per basis;
  * ``dft_tf32``: the flat products with TF32 on;
  * ``dft_bf16``: flat, bf16 operands on the tensor cores, bf16 result
    (what CUDA autocast would run);
  * ``dft_bf16_operands``: flat, operands rounded to bf16, f32 products
    and result (a TPU's DEFAULT precision, the JAX tool's "bf16");
  * ``kernel``: ``spectra`` with dft_mode "auto" under the bf16 policy,
    what the model runs since the frame spectra kernel: on the card one
    launch of ``kernels/spectra.cu`` (a real FFT in f32 of the frames
    read in place; its f32 (mag, re, im) form), on the CPU the product.

Reported per variant: the accuracy of mag, re and im against ``rfft``
(largest error over the spectrum's largest value, RMS error over the
spectrum's RMS) and the time of one call, over ITERS chained calls (each
input biased by the previous output's sum), median of REPEATS, on the
host clock around a synchronize. Writes one JSON (never the JAX tool's
``docs/dft_matmul_probe.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from .bench import power_limit, synchronizer
from .device import matmul_precision, resolve_device
from .models import BiEARConfig
from .models.frontend import device_constants, spectra
from .ops.framing import frame_1s

BATCH = 1024     # both ears of the production batch 512
ITERS = 50
REPEATS = 3


def dft_bases(cfg: BiEARConfig, device) -> tuple:
    """(win, F) cos / sin DFT bases with the Hann window folded in: the
    frontend's own constants (rfft(pad(w x, n_fft))[k] = sum_{n<win} w[n]
    x[n] e^{-2i pi k n / n_fft})."""
    c = device_constants(cfg, device)
    return c["dft_re"], c["dft_im"]


def model_spectra(cfg: BiEARConfig, dft_mode: str, **policy):
    """wav -> (mag, re, im) through the model's own ``spectra`` under
    `dft_mode` ("fft", "matmul" or "auto") and the config fields
    `policy`."""
    cfg = dataclasses.replace(cfg, dft_mode=dft_mode, **policy)
    return lambda wav: spectra(cfg, wav, device_constants(cfg, wav.device))


def make_spectra_dft(cfg: BiEARConfig, dtype: torch.dtype,
                     round_only: bool = False, precision: str = "highest"):
    """wav -> (mag, re, im) as products of the flattened (B T, W) frames
    with the DFT bases, operands in `dtype` (the result widened to f32),
    or operands only rounded to `dtype` and f32 products (`round_only`),
    under MATMUL_PRECISION `precision`."""
    def run(wav):
        c = device_constants(cfg, wav.device)
        Cre, Cim = dft_bases(cfg, wav.device)
        fr = frame_1s(wav, cfg.fs, cfg.timesteps, c["win"], c["hop"])
        cast = ((lambda a: a.to(dtype).float()) if round_only
                else (lambda a: a.to(dtype)))
        flat, Cre, Cim = cast(fr.reshape(-1, c["win"])), cast(Cre), cast(Cim)
        with matmul_precision(precision):
            re = (flat @ Cre).float().reshape(*fr.shape[:2], -1)
            im = (flat @ Cim).float().reshape(*fr.shape[:2], -1)
        return torch.sqrt(re * re + im * im), re, im
    return run


def variants(cfg: BiEARConfig) -> dict:
    return {
        "rfft": model_spectra(cfg, "fft"),
        "dft_f32": model_spectra(cfg, "matmul"),
        "dft_f32_flat": make_spectra_dft(cfg, torch.float32),
        "dft_tf32": make_spectra_dft(cfg, torch.float32,
                                     precision="tensorfloat32"),
        "dft_bf16": make_spectra_dft(cfg, torch.bfloat16),
        "dft_bf16_operands": make_spectra_dft(cfg, torch.bfloat16,
                                              round_only=True),
        "kernel": model_spectra(cfg, "auto", fb_w_dtype="bfloat16"),
    }


def probe_waves(batch: int, fs: int = 16000, seed: int = 0) -> np.ndarray:
    """Speech-like test signal (the JAX tool's): three tones with a small
    per-row detune, plus noise, peak-normalised."""
    rng = np.random.default_rng(seed)
    t = np.arange(fs) / float(fs)
    wav = sum(np.sin(2 * np.pi * f * t[None]
                     * (1 + 0.01 * rng.standard_normal((batch, 1))))
              for f in (220.0, 880.0, 3500.0))
    wav = (wav + 0.1 * rng.standard_normal((batch, fs))).astype(np.float32)
    return wav / np.abs(wav).max()


def accuracy(ref, got) -> dict:
    """Per component: max |error| / max |spectrum| and RMS error / RMS
    spectrum, the spectrum being all three reference components."""
    ref = [r.double().cpu() for r in ref]
    scale = max(float(r.abs().max()) for r in ref)
    out = {}
    for comp, r, g in zip(("mag", "re", "im"), ref, got):
        e = r - g.double().cpu()
        out[comp] = {
            "max_abs_vs_specmax": float(e.abs().max()) / scale,
            "rms_vs_specrms": float(e.square().mean().sqrt()
                                    / r.square().mean().sqrt()),
        }
    return out


def chained_ms(fn, wav: torch.Tensor, iters: int, repeats: int) -> dict:
    """ms per call over `iters` dependent calls (each input biased by the
    previous outputs' sum), median and all of `repeats` windows."""
    sync = synchronizer(wav.device)

    def run():
        carry = torch.zeros((), device=wav.device)
        for _ in range(iters):
            mag, re, im = fn(wav + carry * 1e-12)
            carry = mag.sum() + re.sum() + im.sum()
        return carry

    run()
    times = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        times.append((time.perf_counter() - t0) / iters * 1e3)
    return {"median": statistics.median(times), "all": times}


@torch.inference_mode()
def probe(cfg: BiEARConfig | None = None, batch: int = BATCH,
          iters: int = ITERS, repeats: int = REPEATS, device=None) -> dict:
    """The probe's JSON (runs on the card unless device='cpu')."""
    device = resolve_device(device)
    cfg = cfg or BiEARConfig()
    wav = torch.as_tensor(probe_waves(batch, cfg.fs), device=device)
    runs = variants(cfg)
    ref = runs["rfft"](wav)
    out = {"what": "windowed DFT products vs torch.fft.rfft for the "
                   "frontend spectra",
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "power_limit": power_limit(device),
           "batch_rows": batch * cfg.timesteps, "iters": iters}
    for name, fn in runs.items():
        if name != "rfft":
            out[f"accuracy_{name}"] = accuracy(ref, fn(wav))
    for name, fn in runs.items():
        out[f"ms_per_call_{name}"] = chained_ms(fn, wav, iters, repeats)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--out", default="docs/torch_dft_matmul_probe.json")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)
    out = probe(batch=args.batch, iters=args.iters, device=args.device)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
