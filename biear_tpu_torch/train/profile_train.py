#!/usr/bin/env python3
"""Where the training time goes on the card: the fused synthesize -> train
pipeline of the flagship model, the bare train step, per-stage times and a
kernel breakdown.

    python -m biear_tpu_torch.train.profile_train [--batch 512]
        [--policy bf16|f32] [--controller-mode dual|single]
        [--model active|passive|auralnet]
        [--scene anechoic|spirit|auditorium]
        [--chunk 16] [--windows 3] [--out f.json]

Counterpart of ``bench.py::measure_ours``: the flagship config
(``bench.py:100-102``), or with ``--controller-mode single`` that of
``conf/config_single_ctrl.yaml`` (``serve.profile_serve.GEOMETRY``), at
full width, seeded random weights, and the
synthesizer fixture of ``bench.py`` (``make_test_hrir_bank()``,
``make_test_segments(256)``, 100 lags). Policies: bf16 = bf16 filterbank
operands and the bf16 HRIR mix (the CUDA mix kernel); f32 = both in f32
(the CUDA window gather, then an f32 product). ``--model passive`` trains
``PassiveBiEAR`` on the features of the synthesised waveforms
(``PassiveFeatureSynth``; its bare step runs on one synthesised batch);
``--model auralnet`` trains AuralNet at ``conf/config_auralnet_deepear.
yaml``'s width (``serve.profile_serve.AURALNET``);
``--scene spirit`` or ``auditorium`` synthesises with the scene's built-in
BRIR bank (``ReverbSynthesizer``, where the mix policy does not apply).

Reported:
  * fused pipeline utterances/s: host clock around ``--windows`` chunks of
    ``--chunk`` (synthesize -> step) iterations, each ending in a
    synchronize; median, min and max over the windows;
  * bare step utterances/s: the same on one fixed batch in device memory;
  * stage times of the fused chunk's own replays (``stages["marked"]``),
    device ms per step between the stage marks its graph holds
    (``biear_tpu_torch.trace``): synthesis, forward (loss included),
    backward, update (optimizer, telemetry, metric row), the gap between
    replays, the host's launch of a replay and the host's time in the
    chunk call per step (the call returns once its replays are queued),
    means over the windows' replays (the summary leaves out the warm-up
    call, whose wall holds the capture);
  * kernel-alone CUDA-event times (median of 5, eager launches of one
    kernel or one call, so each holds its own launch): the mix (the kernel
    alone on the anechoic fast path, the whole mix otherwise), the CC
    kernel, the passive features of both ears, one replay of the captured
    bare step;
  * torch.profiler over two fused one-step chunks: device-busy time,
    idle share of the wall time, host launches and the top kernels;
  * peak device memory of the train step's warm-up and capture;
  * each graph's warm-up and capture ms and its memory pool's bytes.

The chunk and the step run as captured CUDA graphs (``train/graph.py``),
as every training entry point on the card does; the stage times are
those of the graph's replays, not of eager calls (whose launch gaps an
event pair counts).
Needs a CUDA card; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..data.passive_synth import PassiveFeatureSynth
from ..data.synth import (AnechoicSynthesizer, build_synthesizer,
                          make_test_hrir_bank, make_test_segments)
from ..data.synth_reverb import ReverbSynthesizer
from ..models import BiEARConfig, build_active, build_auralnet, build_passive
from ..ops.window_gather import cc_kept_lags, gather_mix_kb, gather_windows
from ..ops.xcorr import lag_plan
from .. import trace
from ..serve.profile_serve import AURALNET, GEOMETRY, device_profile
from .loop import make_train_chunk, make_train_step
from .optim import TrainHyper, make_optimizer

POLICIES = {"bf16": "bfloat16", "f32": "float32"}


def events_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of fn(None), after one warm-up call."""
    fn(None)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(None)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rate_windows(run, utt_per_run: int, windows: int,
                 sync=torch.cuda.synchronize) -> dict:
    """Utterances/s of `windows` host-clock windows of run(), each begun
    and ended by sync()."""
    rates = []
    for _ in range(windows):
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        rates.append(utt_per_run / (time.perf_counter() - t0))
    return {"median": statistics.median(rates), "min": min(rates),
            "max": max(rates), "windows": rates}


def fixed_batch(B: int, n_bands: int, seed: int, device) -> tuple:
    """bench.py's bare-step batch: uniform waveforms and x3, one source per
    utterance in a random sector with a random distance class."""
    rng = np.random.default_rng(seed)
    wavL = rng.uniform(-1, 1, (B, 16000)).astype(np.float32)
    wavR = rng.uniform(-1, 1, (B, 16000)).astype(np.float32)
    x3 = rng.uniform(-1, 1, (B, n_bands)).astype(np.float32)
    y = np.zeros((B, 8, 7), np.float32)
    y[:, :, 2] = 1.0
    for b in range(B):
        s = rng.integers(0, 8)
        y[b, s, :3] = (1.0, rng.uniform(), 0.0)
        y[b, s, 3 + rng.integers(0, 4)] = 1.0
    return tuple(torch.as_tensor(a, device=device)
                 for a in (wavL, wavR, x3, y.reshape(B, 56)))


def mix_stage(synth, B: int, gen):
    """(name, one-argument timing closure) of the synthesizer's mix: the
    kernel alone on the anechoic fast path, the whole mix otherwise."""
    if isinstance(synth, ReverbSynthesizer):
        head, active, _, speakers, seg_idx, qoff = synth.scene_batched(gen, B)
        return "mix_ms", lambda _: synth.mix(head, active, speakers, seg_idx,
                                             qoff)
    active, _, meas, seg_idx, qoff, crop = synth.scene_batched(gen, B)
    if not synth.fast:
        return "mix_ms", lambda _: synth.mix_general(active, meas, seg_idx,
                                                     qoff, crop)
    X = active.numel()
    rows = (seg_idx * synth.n_q + qoff).reshape(X)
    bank = synth.bank
    if synth.mix_dtype == "bfloat16":
        return "mix_kernel_ms", lambda _: gather_mix_kb(
            bank["pool3"], rows, crop.reshape(X), meas.reshape(X), bank["KB"],
            synth.fs // 128)
    return "mix_kernel_ms", lambda _: gather_windows(bank["pool3"], rows,
                                                     crop.reshape(X))


def stage_times(synth, batch, gen, train, marked) -> dict:
    """The fused chunk's marked stage times (`marked`,
    ``trace.replay_summary`` of its calls) beside the kernel-alone
    CUDA-event times."""
    B = batch[0].shape[0]
    inner = getattr(synth, "inner", synth)
    mix_name, mix = mix_stage(inner, B, gen)
    wl, wr = inner.sample_batch(gen, B)[:2]
    kept = lag_plan(wl.shape[1], inner.fs, inner.num_lags, 3.0)[0]
    lf = wl - wl.mean(-1, keepdim=True)
    rf = wr - wr.mean(-1, keepdim=True)
    out = {
        "marked": marked,
        mix_name: events_ms(mix),
        "mix_policy": getattr(inner, "mix_dtype", "float32"),
        "cc_kernel_ms": events_ms(
            lambda _: cc_kept_lags(lf, rf, int(np.abs(kept).max()))),
        "train_step_ms": events_ms(lambda _: train(batch, gen)),
    }
    if synth is not inner:
        out["passive_features_ms"] = events_ms(
            lambda _: synth.to_passive((wl, wr, None, None)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--policy", default="bf16", choices=tuple(POLICIES))
    ap.add_argument("--controller-mode", default="dual",
                    choices=tuple(GEOMETRY))
    ap.add_argument("--model", default="active",
                    choices=("active", "passive", "auralnet"))
    ap.add_argument("--scene", default="anechoic",
                    choices=("anechoic", "spirit", "auditorium"))
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dtype = POLICIES[args.policy]
    geometry = (AURALNET if args.model == "auralnet"
                else GEOMETRY[args.controller_mode])
    cfg = BiEARConfig(**geometry, fb_w_dtype=dtype)
    B = args.batch
    hp = TrainHyper()
    if args.scene == "anechoic":
        ir, az, dist = make_test_hrir_bank()
        synth = AnechoicSynthesizer(ir, az, dist, make_test_segments(256),
                                    fs=cfg.fs, num_lags=cfg.n_bands,
                                    mix_dtype=dtype)
    else:
        synth = build_synthesizer(args.scene, None, make_test_segments(256),
                                  cfg.fs, num_lags=cfg.n_bands)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    if args.model == "passive":
        synth = PassiveFeatureSynth(synth, data_dim=cfg.n_bands,
                                    timesteps=cfg.timesteps)
        model = build_passive(cfg, seed=args.seed)
    elif args.model == "auralnet":
        model = build_auralnet(cfg, seed=args.seed)
    else:
        model = build_active(cfg, seed=args.seed)
    opt = make_optimizer(model, hp)
    chunk = make_train_chunk(model, hp, opt, synth.batch_fn(B), args.chunk)
    one_step = make_train_chunk(model, hp, opt, synth.batch_fn(B), 1)
    trace.reset()                    # the marks summarised are this chunk's
    chunk(gen)                                       # warm-up
    fused = rate_windows(lambda: chunk(gen), B * args.chunk, args.windows)
    marked = trace.replay_summary(profiled=False)

    batch = (synth.sample_batch(gen, B) if args.model == "passive"
             else fixed_batch(B, cfg.n_bands, args.seed, "cuda"))
    train = make_train_step(model, hp, opt)
    torch.cuda.reset_peak_memory_stats()
    train(batch, gen)                     # warm-up and capture
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    steps = lambda: [train(batch, gen) for _ in range(args.chunk)]
    bare = rate_windows(steps, B * args.chunk, args.windows)
    result = {
        "card": smi, "batch": B, "policy": args.policy, "chunk": args.chunk,
        "controller_mode": args.controller_mode, "model": args.model,
        "scene": args.scene,
        "fused_train_pipeline_utterances_per_sec": fused,
        "model_step_utt_s": bare,
        "stages": stage_times(synth, batch, gen, train, marked),
        "profile_fused_step": device_profile(
            lambda: one_step(gen), calls=2),
        "peak_memory_bytes_train_step": peak,
        "capture": {"chunk": chunk.stats, "one_step_chunk": one_step.stats,
                    "train_step": list(train.stats.values())},
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
