#!/usr/bin/env python3
"""Training throughput of the port on the card: the counterpart of
``bench.py``.

    python -m biear_tpu_torch.bench [--f32-parity] [--trace DIR]

Prints ONE JSON line with the keys of ``bench.py``'s line, and the card's
power limit under ``power_limit``:

  * ``value``: the production training pipeline, the fused synthesize ->
    train chunk (``train.loop.make_train_chunk`` over ``data.synth.
    AnechoicSynthesizer``: scene draw, the HRIR mix kernel, the CC kernel,
    forward, backward, Adam) of the flagship dual-controller adaptive-Q
    model at BATCH, median utterances/s of WINDOWS windows of
    CHUNK_DISPATCHES chunks of CHUNK steps; ``best`` and ``windows``
    beside it;
  * ``model_step_utt_s``: the bare train step (``train.loop.
    make_train_step``) on one fixed batch in device memory (``bench.py``'s
    batch), WINDOWS windows of STEPS steps;
  * ``flops_per_utt``: ``torch.utils.flop_counter.FlopCounterMode`` over
    one train step (forward, backward, Adam) of a CPU copy of the model
    at full width on FLOP_ROWS rows, divided by the rows. The counter
    sees the products (mm, addmm, bmm); on the card ``nn.GRU`` runs as
    cuDNN's ``_cudnn_rnn``, which it has no formula for, so the count is
    taken on the CPU, where the GRUs are mm and addmm. Elementwise work,
    reductions and FFTs count nothing (XLA's count in ``bench.py`` has
    them); per-op counts go to stderr;
  * ``mfu``: bare-step utt/s x flops_per_utt / the card's dense bf16 peak
    (PEAK_FLOPS; null for a card not in it), to 3 significant digits;
  * ``vs_baseline``: the fused median over ``BENCH_BASELINE.json``'s
    reference rate, which this module reads and never writes (the
    reference is not measured here);
  * ``sync``: every window ends in ``torch.cuda.synchronize()``.

On the card both run as captured CUDA graphs (``train/graph.py``: the
step replayed per step, the chunk's synthesize -> step replayed per step
of a chunk); the warm-up call captures them. The flagship config is
``bench.py``'s; ``--f32-parity`` runs the f32
filterbank operands, the rFFT and the f32 mix (the window-gather kernel
and an f32 product) in place of the bf16 policy. The step runs under the
process-wide MATMUL_PRECISION (``device.matmul_precision``, "default").
``--trace DIR`` writes a ``torch.profiler`` trace of 4 bare steps.
Runs on the card; ``measure(device="cpu", ...)`` runs it on the CPU at any
size, where the rates are CPU rates.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

from .data.synth import (AnechoicSynthesizer, make_test_hrir_bank,
                         make_test_segments)
from .device import resolve_device
from .models import BiEARConfig, build_active
from .train.loop import make_train_chunk, make_train_step, train_step
from .train.optim import TrainHyper, make_optimizer
from .train.profile_train import fixed_batch, rate_windows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_CACHE = os.path.join(REPO, "BENCH_BASELINE.json")
BATCH = 512    # bench.py's operating point
CHUNK = 16     # steps per fused chunk
STEPS = 20     # bare steps per window
CHUNK_DISPATCHES = 3   # chunks per fused window
WINDOWS = 3
FLOP_ROWS = 2  # rows of the CPU step the FLOP count runs on
SEGMENTS = 256  # speech pool of the synthesizer fixture (bench.py:174)

# Dense bf16 tensor-core peak per card, FLOP/s: NVIDIA H100 SXM5 data sheet
# (989.4 TFLOPS bf16 without sparsity).
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12}


def flagship_config(fb_w_dtype: str = "bfloat16", **kw) -> BiEARConfig:
    """``bench.py``'s flagship (dual controller, relative deltaQ 1.0 / 0.3
    / 5.0) under the filterbank policy; `kw` overrides other fields."""
    return BiEARConfig(controller_mode="dual", deltaQ_mode="relative",
                       deltaQ_base=1.0, deltaQ_low_factor=0.3,
                       deltaQ_high_factor=5.0, fb_w_dtype=fb_w_dtype, **kw)


def synchronizer(device: torch.device):
    """A no-argument wait for `device`'s queued work."""
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def power_limit(device: torch.device) -> str | None:
    """The card's power limit as nvidia-smi gives it, None off a card."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}",
         "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bare_step_rates(cfg: BiEARConfig, hp: TrainHyper, batch: int,
                    steps: int, windows: int, device,
                    trace_dir: str | None = None) -> list:
    """utt/s of `windows` windows of `steps` train steps on one fixed
    batch (a fresh seeded model and optimizer, one warm-up step, which
    captures it on the card)."""
    device = resolve_device(device)
    sync = synchronizer(device)
    model = build_active(cfg, seed=0, device=device)
    opt = make_optimizer(model, hp)
    data = fixed_batch(batch, cfg.n_bands, 0, device)
    gen = torch.Generator(device=device).manual_seed(0)
    train = make_train_step(model, hp, opt)
    step = lambda: train(data, gen)
    step()
    rates = rate_windows(lambda: [step() for _ in range(steps)],
                         batch * steps, windows, sync)["windows"]
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            for _ in range(4):
                step()
            sync()
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "bench_trace.json")
        prof.export_chrome_trace(path)
        print(f"[bench] profiler trace written to {path}", file=sys.stderr)
    return rates


def fused_rates(cfg: BiEARConfig, hp: TrainHyper, batch: int, chunk: int,
                dispatches: int, windows: int, mix_dtype: str, device,
                segments: int = SEGMENTS) -> list:
    """utt/s of `windows` windows of `dispatches` fused chunks of `chunk`
    synthesize -> train steps (``bench.py``'s synthesizer fixture, a fresh
    seeded model and optimizer, one warm-up chunk, which captures it on
    the card)."""
    device = resolve_device(device)
    ir, az, dist = make_test_hrir_bank()
    synth = AnechoicSynthesizer(ir, az, dist, make_test_segments(segments),
                                fs=cfg.fs, num_lags=cfg.n_bands,
                                mix_dtype=mix_dtype, device=device)
    model = build_active(cfg, seed=0, device=device)
    opt = make_optimizer(model, hp)
    run = make_train_chunk(model, hp, opt, synth.batch_fn(batch), chunk)
    gen = torch.Generator(device=device).manual_seed(0)
    run(gen)
    return rate_windows(lambda: [run(gen) for _ in range(dispatches)],
                        batch * chunk * dispatches, windows,
                        synchronizer(device))["windows"]


def train_flops_per_utt(cfg: BiEARConfig, hp: TrainHyper,
                        rows: int = FLOP_ROWS) -> tuple:
    """(FLOPs per utterance, {op: FLOPs per utterance}) of one train step
    on a CPU copy of the model: what ``FlopCounterMode`` counts, i.e. the
    products. Every product's rows are batch rows, so the count per
    utterance does not depend on `rows`."""
    from torch.utils.flop_counter import FlopCounterMode
    model = build_active(cfg, seed=0, device="cpu")
    opt = make_optimizer(model, hp)
    data = fixed_batch(rows, cfg.n_bands, 0, "cpu")
    gen = torch.Generator().manual_seed(0)
    with FlopCounterMode(display=False) as counter:
        train_step(model, hp, opt, data, gen)
    by_op = {str(k): v / rows
             for k, v in counter.get_flop_counts()["Global"].items()}
    return counter.get_total_flops() / rows, by_op


def read_baseline() -> tuple:
    """(reference utt/s, its device) from ``BENCH_BASELINE.json``, or
    (None, None) without the file."""
    if not os.path.exists(BASELINE_CACHE):
        return None, None
    with open(BASELINE_CACHE) as f:
        cached = json.load(f)
    return (cached.get("reference_utterances_per_sec"),
            cached.get("baseline_device"))


def measure(device=None, batch: int = BATCH, chunk: int = CHUNK,
            steps: int = STEPS, chunk_dispatches: int = CHUNK_DISPATCHES,
            windows: int = WINDOWS, fb_w_dtype: str = "bfloat16",
            mix_dtype: str = "bfloat16", trace_dir: str | None = None,
            model_cfg: BiEARConfig | None = None,
            segments: int = SEGMENTS) -> dict:
    """``bench.py``'s line for the flagship under the filterbank policy
    `fb_w_dtype` and the mix policy `mix_dtype` (or `model_cfg`), with
    ``flops_by_op`` (per utterance) beside it. Runs on the card unless
    device='cpu'."""
    device = resolve_device(device)
    cfg = model_cfg or flagship_config(fb_w_dtype)
    hp = TrainHyper()
    step = bare_step_rates(cfg, hp, batch, steps, windows, device,
                           trace_dir)
    fused = fused_rates(cfg, hp, batch, chunk, chunk_dispatches, windows,
                        mix_dtype, device, segments)
    flops, by_op = train_flops_per_utt(cfg, hp)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    peak = PEAK_FLOPS.get(name)
    step_median = statistics.median(step)
    fused_median = statistics.median(fused)
    baseline, baseline_dev = read_baseline()
    return {
        "metric": "fused_train_pipeline_utterances_per_sec",
        "value": round(fused_median, 2),
        "unit": "utt/s",
        "vs_baseline": (round(fused_median / baseline, 2) if baseline
                        else None),
        "best": round(max(fused), 2),
        "windows": [round(r, 1) for r in fused],
        "model_step_utt_s": round(step_median, 2),
        "model_step_windows": [round(r, 1) for r in step],
        "flops_per_utt": round(flops),
        "mfu": (float(f"{step_median * flops / peak:.3g}") if peak
                else None),
        "device": name,
        "baseline_device": baseline_dev,
        "batch": batch,
        "fb_w_dtype": cfg.fb_w_dtype,
        "synth_mix_dtype": mix_dtype,
        "sync": ("torch.cuda.synchronize" if device.type == "cuda"
                 else None),
        "power_limit": power_limit(device),
        "flops_by_op": by_op,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler trace of 4 bare steps")
    ap.add_argument("--f32-parity", action="store_true",
                    help="the f32 filterbank and mix policy in place of "
                         "the production bf16 policy")
    args = ap.parse_args(argv)
    dtype = "float32" if args.f32_parity else "bfloat16"
    out = measure(trace_dir=args.trace, fb_w_dtype=dtype, mix_dtype=dtype)
    print(json.dumps({"flops_by_op": out.pop("flops_by_op")}),
          file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
