#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``biear_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then not 0):

  1. device: a CUDA card is required; its name and power limit are printed.
  2. build: every CUDA kernel of the port is compiled from the sources in
     this checkout (kernels/cc_lags.cu, gather_windows.cu, gather_mix_kb.cu),
     one nvcc per source, all started together. The ptxas report of every
     entry function (registers, spills, shared memory) is caught and
     logged; a spill in cc_lags.cu or gather_mix_kb.cu fails the run.
  3. kernel vs plain: each kernel is held against its plain PyTorch version
     on the card (TF32 off) at the shapes of the main paths (the runner's
     too: batches of 64 rows and the test split's 21- and 22-row thirds,
     RUNNER_ROWS) and at ragged ones (CC: batch 1 and 3, n = 128 and
     16000, K = 1, 17 and 63; mix: one
     window, 1, 64, 65 and 128 frames, banks of 128, 256 and 512 rows and
     of one measurement, indices out of range that must clamp; window
     gather: every X the main paths launch it at, 3 to 1536, the shape of
     tools/bench_win_kernel.py, X = 1 and indices past the clamps), and
     timed beside its plain version, one library call and the card's
     bound for the same work (the window gather at each X also per
     launch in a CUDA graph, with its pool warm and cold in L2, and with
     a fill and a copy of its output's bytes and the kernel on one pool
     row as floors). Two launches of each kernel on the same inputs must
     give the same bits; a pool view off the 16-byte grid must be refused
     by the window gather.
  4. serve: the flagship dual-controller adaptive-Q model at full width,
     seeded random weights, through ``serve.infer.predict`` at batch 1, 64
     and 512 under the bf16 policy and at batch 64 under the f32 policy.
     The launch counts are zeroed just before and read just after; each
     kernel of the path must have launched. Then the outputs are checked
     (shapes, finite, probabilities in [0, 1], Q adapting, the CUDA CC
     against the plain CC end to end, the card against the CPU on a small
     batch) and batch-512 throughput is timed.
  5. train: the fused synthesize -> train chunk (``train.loop.
     make_train_chunk``) of the flagship at full width, batch 512, bf16
     policy, with the synthesizer fixture of bench.py, for TRAIN_STEPS
     steps; launch counts zeroed just before and read just after (one mix
     and one CC launch per step). Then: finite losses, no skipped step,
     finite non-zero gradient norms in both groups, parameters of both
     groups moved (the controllers' zero-initialised output layer too, so
     it got a non-zero gradient); one f32-policy step at batch 64 through
     the window-gather kernel; one step's loss and gradients on the card
     against the CPU port (same weights, dropout 0, f32, on a synthesised
     and on bench.py's white-noise batch of 4; the frontend's limit from
     the CPU's own spread under waveform noise on the same batch, see
     STEP_LOSS_ATOL); and the fused-pipeline and bare-step rates at batch
     512.
  6. single serve: phase 4 for the single-controller model
     (conf/config_single_ctrl.yaml's geometry: one shared controller,
     absolute deltaQ, base 2.0, low 0.5, high 5) at full width.
  7. single train: a SINGLE_TRAIN_STEPS-step fused chunk of the single-
     controller model at batch 512, bf16 (one mix and one CC launch per
     step, finite losses, nothing skipped, both groups and the shared
     controller's zero-initialised output layer move), with its rates.
  8. stream: ``serve.streaming.stream_apply`` of the dual, single and
     fixed-Q models at full width, batch 64, against the model's forward
     on the same crop (STREAM_ATOL on every output, f32 with TF32 off and
     bf16 with the DFT as a product); half the slots reset mid-stream must
     equal fresh streams bit for bit; per-hop times at batch 1 and 512.
  9. evaluate: a 256-row shard synthesised on the card (the bf16 mix and
     CC kernels), written to a temporary directory, evaluated with
     ``train.evaluate.evaluate`` for a seeded single-controller model on
     the card; its predictions against the CPU port's on the same shard:
     equal row by row except where a presence logit or distance margin
     lies within the serving tolerance of its boundary (counted and
     printed); over all rows, the accuracies that ``evaluate`` returned on
     the card differ from the CPU's by no more than the flipped presence /
     distance decisions; MAE to 1e-4.
 10. runner: ``train.runner.train`` from ``load_run_config("conf/config.
     yaml")`` at full width (the flagship, batch 64, f32 policy) with the
     config's own synthesizer (``train_biear.make_synth``), RUNNER_STEPS
     steps per epoch in chunks of RUNNER_CHUNK, eval splits of RUNNER_EVAL
     rows, 2 epochs in a temporary RUNS_ROOT, then resumed for a third;
     launch counts zeroed just before the first run and read after the
     resume: one CC and one window-gather launch per training step and per
     synthesised eval or sanity batch, no bf16 mix. Then: the run tree
     (settings, 3 history entries, scalars, test metrics, best and last
     with parameters and Adam state), finite losses, nothing skipped,
     global_step 24, ``last`` restoring to the bits of the in-memory model
     and optimizer; ``evaluate`` on ``checkpoints/best`` against a 256-row
     shard synthesised on the card. Logged: seconds per epoch, the
     runner's training rate against ``make_train_chunk``'s bare rate at
     the same batch and policy, checkpoint write and eval-split
     materialisation ms, peak memory.
 11. passive: (a) ``ops.features.passive_features`` of FEATURE_BATCH
     synthesised waveforms on the card against the CPU port (above -60
     dB: wrapped phase FEATURE_RAD_TOL, magnitude FEATURE_DB_TOL; the
     padded frame -80); (b) a fused chunk of ``PassiveBiEAR`` at full
     width through ``PassiveFeatureSynth`` over the bf16 synthesizer,
     TRAIN_BATCH, TRAIN_STEPS steps (one mix and one CC launch per step,
     finite losses, nothing skipped), fused and bare rates; (c) the runner
     on conf/config_passive.yaml made synthesised as phase 10 does, 2
     epochs (one CC and one window-gather launch per training step and
     per synthesised eval or sanity batch, no bf16 mix; the run tree),
     seconds per epoch and utt/s; (d) ``evaluate`` of
     docs/protocol_r3/passive/best.pth on an EVAL_ROWS-row passive shard
     synthesised on the card, card against CPU by phase 9's rules with
     each row's tolerance widened to the CPU's own change under 1e-6
     relative input noise (the trained checkpoints are ill-conditioned at
     the rounding level).
 12. reverberant and general paths: (a) ``ReverbSynthesizer`` batches of
     the built-in spirit and auditorium banks at REVERB_BATCH, card
     against CPU on the same draws (waveforms WAVE_ATOL, labels bit for
     bit; one CC launch per batch, no window or mix launch); (b) the
     runner on conf/config_spirit.yaml as written (flagship, batch 64,
     f32, the built-in spirit bank), one epoch; (c) a flagship fused chunk
     at REVERB_BATCH on the general anechoic path, a pool of 19,200-sample
     segments (CC each step, no window or mix launch); (d) ``evaluate`` of
     docs/protocol_r3/spirit/best.pth on an EVAL_ROWS-row spirit shard
     synthesised on the card, card against CPU as in 11 (d).
 13. AuralNet at conf/config_auralnet_deepear.yaml's width (seeded
     weights): (a) phase 4's serving checks (cc_lags once per predict,
     card vs CPU at SERVE_TOL, batch-512 throughput); (b) a fused chunk at
     TRAIN_BATCH, bf16, TRAIN_STEPS steps (one mix and one CC launch per
     step, finite losses, nothing skipped, all three attention blocks and
     the backend moved), fused and bare rates; an f32 step at batch 64
     (one window gather) and one f32 step card vs CPU on a synthesised
     batch of 64, dropout 0, stage by stage (the log features to
     AURALNET_FEAT_ATOL, the loss, the gradients on the card's features);
     (c) the runner on the config as phase 11 (c) runs its config, 2
     epochs, no Q plots; (d) ``evaluate`` of that run's checkpoints/best
     on an EVAL_ROWS-row shard synthesised on the card, card against CPU
     as in 9; (e) ``stream_init`` refuses the model.
 14. protocol: ``run_full_protocol`` at full width, speech corpus, noise
     at 5-25 dB, pool, train and eval sizes PROTOCOL_SIZES, one epoch, for
     AuralNet and for conf/config.yaml --fixed-q (one CC and one window
     gather per batch, no mix; pool seconds, train utt/s, ms per test
     split); ``protocol_eval`` on the AuralNet run reproduces its test1 /
     test2 files byte for byte; ``eval_by_snr`` over both runs at 5 dB,
     25 dB and clean.
 15. dataset, at full width in a temporary directory: (a)
     ``generate_binaural_data`` writes an anechoic test-thirds split of
     DATASET_ROWS rows on the card (wav + npz pairs; one window-gather and
     one CC launch per 256-row batch; source counts 1/2/3 per third; every
     npz rebuilds its batch's label bit for bit) and a SPIRIT_ROWS-row
     spirit split (rFFT mix: one CC launch); (b) ``precompute_h5
     --from-dir`` turns (a) into the active and passive val / test
     ``.shard`` files, the card against the CPU port on COMPARE_ROWS rows
     (x1, x2, y bit for bit, CC to CC_RTOL / CC_ATOL, features to
     FEATURE_DB_TOL / FEATURE_RAD_TOL), ms per 512 rows of each builder;
     (c) ``precompute_h5 --synth SYNTH_ROWS`` writes the train shards; (d)
     the runner on conf/config.yaml and conf/config_passive.yaml, one
     epoch each from those files (s per epoch and utt/s beside phase
     10's), then ``evaluate`` of the active run's best on the test shard,
     card against CPU as in 9; (e) ``stream_demo`` on
     docs/protocol_r3/flagship-s1 (n_src 2, seed 4): per-hop beliefs card
     against CPU on the card's scene (STREAM_ATOL, or the CPU's own spread
     under 1e-6 noise where the trained checkpoint needs it), ms per hop,
     the settled hop and the decision; (f) ``archive_protocol_run`` of
     phase 14's AuralNet run: metric files byte-copied, the exported
     best.pth loads strictly into a fresh AuralNet and, scored on phase
     14's splits, writes its test1 / test2 files byte for byte.
 16. distributed: the runner across processes started by ``torchrun``
     (``python -m torch.distributed.run --standalone``; each rank is this
     script with ``--dist-worker``), conf/config.yaml at full width,
     dropout 0, one epoch of RUNNER_STEPS steps, against the runner in
     this process without a process group on the same seed: (a) one rank
     over NCCL gives its per-step losses and gradient norms bit for bit
     (over one data rank the step sends and scales nothing, and the
     runner's other collectives over one rank are identities); (b) two
     ranks share the one card, which NCCL refuses (its error is printed),
     so they run over gloo on CUDA tensors, as MESH 2x1 and 1x2: per-step
     losses and gradient norms within DIST_RTOL (at DIST_STEPS_HELD),
     one run tree each, rank 0's best.pth loads strictly into a
     one-device model; (c) the same two ranks run the fused bf16 chunk at
     DIST_RANK_BATCH rows per rank (global batch 512), DIST_CHUNKS chunks
     of DIST_CHUNK_STEPS steps, captured and with capture=False (twice)
     from one state and seed: batches and generator states bit for bit,
     losses and parameters within CAPTURE_WITNESS times the eager pair's
     spread, one mix and one CC launch per step (per replay) on each
     rank. The reference runner, (a) and (b)'s 2x1 are captured (each a
     mesh without a model axis: a step is two graphs around the eager
     all-reduce, one graph over one data rank; their launch counts,
     warm-ups included, equal the reference's), 1x2 runs eagerly. Launch
     counts per rank (cleared just before each run, read just after), the
     flat gradient all-reduce's ms (CUDA events, on a buffer of the step's
     size), utt/s per rank of both paths and, on rank 0, host launches,
     busy ms, kernels per step and idle share of both paths are printed
     beside the card's name and power limit; two processes on one card
     measure no scaling.
 17. bench and precision: (a) ``biear_tpu_torch.bench.measure`` at full
     width, bf16, one window of one 16-step fused chunk and one window of
     5 bare steps (launch counts zeroed just before and read just after:
     the mix and CC kernels launch on its fused path), its line printed
     with "reduced": true; (b) for each MATMUL_PRECISION name, the seeded
     flagship forward (tests/test_precision.py's config, controllers
     perturbed so Q moves) at PRECISION_BATCH on the card against
     "highest" within PRECISION_TOL, the TF32 flags and CUDA autocast of
     the name inside the block and restored after it; (c) one captured
     train step of bench.py's flagship, AuralNet (phase 13's width) and
     the passive model at PRECISION_STEP_BATCH under "tensorfloat32" and
     one under "bfloat16" (captured under the name: bf16 autocast without
     its cast cache): finite loss and gradient norms, nothing skipped;
     (d) ``probe_dft_matmul.probe`` at the production shape
     (batch 1024), DFT_PROBE_ITERS chained calls: each product's spectra
     against cuFFT's within DFT_PROBE_TOL of the spectrum's largest
     value, and the times.

 18. capture: the train chunk as a captured CUDA graph (``train/graph.py``,
     the path every training entry point on the card takes) against the
     eager loop (``capture=False``) from one state and seed: (a) the
     flagship at TRAIN_BATCH under the bf16 and the f32 policy,
     CAPTURE_CHUNKS chunks of CAPTURE_STEPS steps, the generator
     re-seeded before each chunk as the runner does: the synthesised
     waveforms, CC features and labels and the generator state equal bit
     for bit, losses and parameters within CAPTURE_WITNESS times the
     spread of two eager runs, one mix (or window gather) and one CC
     launch per replay; a replay at lr_scale 0 leaves the parameters, a
     parameter given new storage is refused; (b) single, passive,
     AuralNet and the spirit scene, one chunk of CAPTURE_FAMILY_STEPS
     steps each, the same checks; (c) both paths side by side per policy:
     fused and bare-step utt/s, device busy ms, kernels per step, idle
     share and host launches per chunk of CAPTURE_PROFILED_STEPS steps
     (torch.profiler), the capture's ms and its memory pool.

 19. inference capture: the inference programs as captured CUDA graphs
     (``graph.py``: ``Captured``, ``CapturedEvalChunk``, the path every
     serving, streaming and evaluation entry point on the card takes)
     against their eager paths (``capture=False``) from one state,
     within CAPTURE_WITNESS times the spread of two eager runs (bit for
     bit where those agree; each row says whether it was bitwise): (a)
     ``predict`` for INFER_FAMILIES at SERVE_BATCHES, one cc_lags launch
     per replay (WARMUP_STEPS more in the first call), tensor and numpy
     inputs giving the same bits, ms per call both ways, busy ms, idle
     share, kernels and host launches per call at batch 512
     (torch.profiler), the graphs' capture ms and pool bytes, and a call
     under MATMUL_PRECISION "bfloat16" capturing a new graph; (b)
     ``stream_step`` for STREAM_MODES at STREAM_BATCHES, T hops and the
     readout with its tail, the state checked hop by hop, a state held
     from hop 4 unchanged by the later hops, churn through the masked
     ``stream_reset`` checked as phase 8's, ms, host launches, busy ms and
     idle share per hop both ways (churn: captured), real-time factor;
     (c) a runner val split (INFER_EVAL_ROWS rows, stacked) through the
     captured eval chunk against the eager eval step batch by batch
     (per-batch metrics, the split's means, seconds both ways; the bytes
     held after the first eval beyond its graph's pool under half the
     split's: the split is read in place, not copied), and
     ``collect_predictions`` of the active, AuralNet and passive models.

Every train chunk and step above runs captured, and so do phases 4, 6,
8, 9 and 13's serving, streaming and evaluation; the first call of each
captures it after WARMUP_STEPS eager runs, which launch the kernels too,
so a first call counts WARMUP_STEPS launches more.

Prints, before the last line, the card line of nvidia-smi and one JSON
line {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import itertools
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
SERVE_BATCHES = ((1, "bfloat16"), (64, "bfloat16"), (512, "bfloat16"),
                 (64, "float32"))
H100_BF16_FLOPS = 989e12      # dense bf16 tensor cores, H100 SXM data sheet
MIX_ATOL = 5e-5               # JAX's mix kernel vs its XLA composition
TRAIN_BATCH = 512
TRAIN_STEPS = 4
SINGLE_TRAIN_STEPS = 2
SERVE_TOL = {"float32": 2e-3, "bfloat16": 2e-2}   # card vs CPU, serving
STREAM_ATOL = 2e-4            # tests/test_streaming.py
STREAM_BATCH = 64
EVAL_ROWS = 256
RUNNER_STEPS, RUNNER_CHUNK, RUNNER_EVAL = 8, 4, 256
# rows of the runner's batches (phase 10): conf/config.yaml's 64, and the
# last batch of each source-count third of its RUNNER_EVAL-row test split
# (85 = 64 + 21, 85 = 64 + 21, 86 = 64 + 22), with that third's count
RUNNER_ROWS = ((64, 0), (21, 1), (21, 2), (22, 3))
# one f32 train step, card vs CPU port, on a synthesised and on bench.py's
# white-noise batch of 4, stage by stage on the same inputs. The whole
# gradient is not compared: it jumps where a phase difference crosses the
# IPD wrap at +-pi or a body ReLU input crosses 0, and rounding alone
# moves such crossings. Checked: the loss to 1e-5; the backend's gradients
# and the cotangents it returns to the frontend, both sides run on the
# card's frontend outputs, to BACKEND_RTOL in relative L2; the frontend's
# gradients under the card's cotangents, to WITNESS_FACTOR times the
# CPU's own spread under WITNESS_DRAWS draws of white waveform noise,
# scaled to move the CPU's spectra as far as the card's arithmetic does
# (the phase of a weak band moves the Q gradient through 1/|Z|).
STEP_LOSS_ATOL = 1e-5
BACKEND_RTOL = 1e-4
WITNESS_DRAWS, WITNESS_FACTOR = 3, 3.0
# phase 11: passive features card vs CPU above -60 dB, the CPU test's
# limits (tests/test_torch_port_passive.py): wrapped phase 1e-3 rad and the
# magnitude to the same 1e-3 of the band value, 20 log10(1 + 1e-3) dB
FEATURE_BATCH = 64
FEATURE_RAD_TOL = 1e-3
FEATURE_DB_TOL = 20.0 * np.log10(1.0 + FEATURE_RAD_TOL)
# phase 12: reverberant batches, card vs CPU on the same draws
REVERB_BATCH = 64
WAVE_ATOL = 2e-5
# phase 13: AuralNet's log features card vs CPU (cuFFT against pocketfft)
AURALNET_FEAT_ATOL = 1e-4
# phase 14: run_full_protocol's pool, train and eval sizes
PROTOCOL_SIZES = (64, 512, 192)
# phase 15: the written test-thirds split, the spirit split, the card vs
# CPU rows of the precompute, the synthesised train split
DATASET_ROWS, SPIRIT_ROWS, COMPARE_ROWS, SYNTH_ROWS = 768, 192, 64, 2048
# phase 16: two ranks against the world of one, per-step losses at
# tests/test_sharding.py's mesh tolerance and gradient norms at 1e-4
# (tests/test_torch_parallel_steps.py's: Adam and the clip do not see a
# gradient scaled by a constant, its norm does), the distributed bf16
# chunk, the all-reduce timing. The steps held (None: every one): the
# frontend's gradient norm only at the first, where the parameters are
# still equal; after one rounding of the parameters it moves by up to
# 10 % (it runs through the phases of weak bands), while the losses stay
# within 2.5e-7 and the backend's norm within 1.3e-5.
DIST_SCALARS = ("loss", "grad_fb_norm", "grad_backend_norm")
DIST_RTOL = {"loss": 2e-4, "grad_fb_norm": 1e-4, "grad_backend_norm": 1e-4}
DIST_STEPS_HELD = {"loss": None, "grad_fb_norm": 1,
                   "grad_backend_norm": None}
DIST_CHUNK_STEPS, DIST_RANK_BATCH, DIST_CHUNKS = 4, 256, 3
ALLREDUCE_REPS = 20
# phase 17: each MATMUL_PRECISION name's forward against "highest"
# (tests/test_precision.py:92-96: Q, AoA, sound and distance logits), the
# train steps under the reduced names, the DFT probe (f32 products: the
# CPU test's limit; bf16 operands with f32 sums: JAX's ~1e-3 class;
# TF32: inside that class; bf16 results: their rounding, 2^-8 of a value,
# above it)
PRECISION_BATCH = 4
PRECISION_TOL = {"Q": 0.05, "aoa": 0.02, "sound": 0.15, "dist": 0.15}
PRECISION_STEP_BATCH = 64
DFT_PROBE_ITERS = 5
DFT_PROBE_TOL = {"dft_f32": 1e-5, "dft_f32_flat": 1e-5, "dft_tf32": 2e-3,
                 "dft_bf16_operands": 2e-3, "dft_bf16": 5e-3}
# phase 18: the captured train chunk (train/graph.py) against the eager
# one from one state and seed. The synthesised batches and the generator
# state are held bit for bit (the same Philox offsets step for step); the
# losses and parameters within CAPTURE_WITNESS times the spread of two
# eager runs of the same chunks (the witness: the backward's atomic sums
# differ from run to run), and exactly where the two eager runs agree
CAPTURE_CHUNKS, CAPTURE_STEPS = 3, 16
CAPTURE_FAMILY_STEPS = 4
CAPTURE_PROFILED_STEPS = 4     # steps of (c)'s profiled chunk, both paths
CAPTURE_BARE_STEPS = 8        # per window of (c)'s bare-step rate
CAPTURE_WITNESS = 3.0
CAPTURE_SEED = 1000
# phase 19: the captured inference programs (predict, the stream hop, the
# eval chunk and forward) against capture=False from one state, within
# CAPTURE_WITNESS times the spread of two eager runs (exactly where they
# agree); per-call times the median of INFER_REPS synchronised calls
INFER_FAMILIES = ("dual", "single", "auralnet")
STREAM_MODES = (("dual", False), ("single", False), ("dual", True))
STREAM_BATCHES = (1, 64, 512)
INFER_REPS = 7
INFER_EVAL_ROWS = 1024         # SYNTH_EVAL_SAMPLES' default: 16 batches
INFER_PREDICT_ROWS = 256       # collect_predictions' split per family


_START = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, with the seconds since the start."""
    print(f"[chip_smoke {time.perf_counter() - _START:.1f}s] {msg}",
          flush=True)


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


CC_SHAPES = ((512, 16000, 48), (1, 16000, 48), (7, 1024, 63),
             (3, 16000, 63), (3, 128, 1), (1, 128, 63), (5, 2560, 17),
             (64, 16000, 48), (21, 16000, 48), (22, 16000, 48))
# gather_mix_kb.cu beyond the training shape: (windows, frames, bank rows,
# measurements, indices out of range)
MIX_RAGGED = ((1, 1, 384, 1, False), (5, 64, 384, 4, False),
              (5, 65, 384, 4, False), (7, 61, 128, 1, False),
              (4, 125, 512, 3, False), (6, 128, 128, 2, False),
              (9, 33, 256, 5, True))


def phase_kernels(torch, rng):
    """Hold cc_lags.cu against the plain version, time both."""
    from biear_tpu_torch.device import precision_highest
    from biear_tpu_torch.ops.window_gather import cc_kept_lags_cuda
    from biear_tpu_torch.ops.xcorr import cc_kept_lags_plain

    max_err = 0.0
    timing = None
    with precision_highest():
        for B, n, K in CC_SHAPES:
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
            if not torch.equal(got, cc_kept_lags_cuda(lf, rf, K)):
                raise RuntimeError(f"cc_lags B={B} n={n} K={K}: two launches "
                                   "differ")
            log(f"cc_lags B={B} n={n} K={K}: max |kernel - plain| = {err!r}, "
                "two launches bit-equal")
            if timing is None:           # the serving shape
                timing = cc_timing(torch, lf, rf, K)
            elif (B, n, K) == (1, 16000, 48):
                timing["batch1_ms"] = cuda_ms(
                    lambda: cc_kept_lags_cuda(lf, rf, K))
                log(f"cc_lags at batch 1: {timing['batch1_ms']!r} ms")
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
    from biear_tpu_torch.ops.xcorr import (cc_kept_lags_plain,
                                           device_lag_plan, interp_to_lags,
                                           lag_plan)
    from biear_tpu_torch.train.losses import sanitize_wav, sanitize_x3
    cfg = model.cfg
    with torch.inference_mode():
        wavL, wavR = sanitize_wav(wavL, wavR)
        kept = lag_plan(wavL.shape[1], cfg.fs, cfg.n_bands, 3.0)[0]
        j0, w, _ = device_lag_plan(wavL.shape[1], cfg.fs, cfg.n_bands, 3.0,
                                   wavL.device)
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
        for ctrl in model.bifb.controllers():
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


def serve_model(torch, label: str, dtype: str):
    """A seeded model of `label` under one policy: an active geometry
    (``profile_serve.GEOMETRY[label]``, controllers perturbed so Q moves)
    or AuralNet (``profile_serve.AURALNET``)."""
    from biear_tpu_torch.models import (BiEARConfig, build_active,
                                        build_auralnet)
    from biear_tpu_torch.serve.profile_serve import AURALNET, GEOMETRY
    if label == "auralnet":
        return build_auralnet(BiEARConfig(**AURALNET, fb_w_dtype=dtype),
                              seed=0)
    m = build_active(BiEARConfig(**GEOMETRY[label], fb_w_dtype=dtype),
                     seed=0)
    perturb_controllers(torch, m, seed=1)
    return m


def phase_serve(torch, rng, label="dual"):
    """predict of one model (``serve_model``) at SERVE_BATCHES, checked and
    timed."""
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.serve.infer import predict
    from biear_tpu_torch.graph import WARMUP_STEPS

    models = {dt: serve_model(torch, label, dt)
              for dt in ("bfloat16", "float32")}
    wav = {B: [torch.tensor(rng.uniform(-1, 1, (B, 16000)),
                            dtype=torch.float32, device="cuda")
               for _ in range(2)] for B in (1, 64, 512)}

    LAUNCHES.clear()
    outs = {(B, dt): predict(models[dt], *wav[B]) for B, dt in SERVE_BATCHES}
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"{label} serving path launches: {launches}")
    # each served batch is a first call: its capture's WARMUP_STEPS eager
    # runs launch the kernel too, then one replay
    want = len(SERVE_BATCHES) * (1 + WARMUP_STEPS)
    if launches.get("cc_lags", 0) != want:
        raise RuntimeError(f"cc_lags launched {launches.get('cc_lags', 0)} "
                           f"times for {len(SERVE_BATCHES)} served batches "
                           f"(expected {want})")

    for (B, dt), out in outs.items():
        check_outputs(torch, out, B)
        log(f"{label} serve B={B} {dt}: shapes and ranges ok")

    model = models["bfloat16"]
    with torch.inference_mode():
        _, _, _, aux = model(*wav[64])
    if aux["Q"] is not None:
        Q0 = aux["Q"][:, :1]
        q_move = float((aux["Q"][:, 1:] - Q0).abs().max())
        log(f"{label}: max |Q(t) - Q(0)| at B=64: {q_move!r}")
        if not q_move > 1e-4:
            raise RuntimeError("the controllers do not move Q")

    plain = predict_plain_cc(torch, model, *wav[512])
    err = max(float((a - b).abs().max())
              for a, b in zip(outs[(512, "bfloat16")], plain))
    log(f"{label} B=512 CUDA CC vs plain CC, end to end: max abs diff "
        f"{err!r}")
    if not err <= 1e-4:
        raise RuntimeError(f"CUDA-CC forward differs from plain-CC: {err}")

    # the card against the CPU run of the same port (held against the JAX
    # package by the CPU tests), on a small batch
    for dt, tol in SERVE_TOL.items():
        cpu_model = type(models[dt])(models[dt].cfg)
        cpu_model.load_state_dict(models[dt].state_dict())
        wl, wr = (w[:4] for w in wav[64])
        gpu_out = predict(models[dt], wl, wr)
        cpu_out = predict(cpu_model, wl.cpu(), wr.cpu())
        d = max(float((g.cpu() - c).abs().max())
                for g, c in zip(gpu_out, cpu_out))
        log(f"{label} B=4 {dt}: max |card - CPU| = {d!r} (tolerance {tol})")
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
    log(f"{label} serve B=512 bf16: median {t * 1e3!r} ms per batch, "
        f"{512 / t!r} utterances/s")
    return launches


def bound(nbytes: float, flops: float, peak_flops: float) -> dict:
    t_ops, t_bytes = flops / peak_flops, nbytes / H100_HBM_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def training_synth(torch, mix_dtype: str):
    """bench.py's synthesizer fixture on the card."""
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    ir, az, dist = make_test_hrir_bank()
    return AnechoicSynthesizer(ir, az, dist, make_test_segments(256),
                               fs=16000, num_lags=100, mix_dtype=mix_dtype)


def mix_ragged(torch, pool3):
    """gather_mix_kb.cu on seeded random banks at MIX_RAGGED's shapes,
    against the plain version (f64 sums) and an f32 bmm, both to MIX_ATOL;
    two launches must give the same bits. Returns the largest error."""
    from biear_tpu_torch.device import precision_highest
    from biear_tpu_torch.ops import window_gather as wg

    gen = torch.Generator(device="cuda").manual_seed(11)
    NP, nb, _ = pool3.shape
    worst = 0.0
    for X, nf, ncol, M, wild in MIX_RAGGED:
        kb = (torch.randn((M, ncol, 256), generator=gen, device="cuda")
              * 0.1).to(torch.bfloat16)
        draw = lambda lo, hi: torch.randint(lo, hi, (X,), generator=gen,
                                            device="cuda")
        if wild:    # every index may lie outside its range
            rows, offs, meas = (draw(-3, NP + 3), draw(-500, nb * 128 + 500),
                                draw(-2, M + 2))
        else:
            rows, offs, meas = (draw(0, NP), draw(0, nb * 128 - wg.WIN + 1),
                                draw(0, M))
        with precision_highest():
            got = wg.gather_mix_kb_cuda(pool3, rows, offs, meas, kb, nf)
            want = wg.gather_mix_kb_plain(pool3, rows, offs, meas, kb, nf)
            fw = wg.frame_windows(wg.gather_windows_plain(pool3, rows, offs)
                                  .to(kb.dtype), nf, ncol).float()
            f32 = torch.bmm(fw, kb[meas.long().clamp(0, M - 1)].float())
        same = torch.equal(got, wg.gather_mix_kb_cuda(pool3, rows, offs,
                                                      meas, kb, nf))
        e64 = float((got - want).abs().max())
        e32 = float((got - f32).abs().max())
        log(f"gather_mix_kb X={X} nf={nf} ncol={ncol} M={M}"
            f"{' indices out of range' if wild else ''}: max |kernel - plain"
            f" (f64 sums)| = {e64!r}, max |kernel - f32 bmm| = {e32!r} (atol "
            f"{MIX_ATOL}), two launches bit-equal: {same}")
        if not (e64 <= MIX_ATOL and e32 <= MIX_ATOL and same):
            raise RuntimeError(f"gather_mix_kb disagrees at X={X} nf={nf} "
                               f"ncol={ncol} M={M}")
        worst = max(worst, e64)
    return worst


def phase_window_kernels(torch, synth):
    """gather_mix_kb.cu and gather_windows.cu against their plain versions
    at the training shape (batch 512: 1536 windows, 125 frames), at a
    ragged small shape (7 windows, 61 frames) and at the runner's batches
    (RUNNER_ROWS: 192, 63 and 66 windows), on the synthesizer's pool and
    bf16 bank. The mix's plain version sums in f64, so its comparison
    is also the f64 check; the kernel is held to an f32 bmm too."""
    from biear_tpu_torch.device import precision_highest
    from biear_tpu_torch.kernels.time_kernels import (gather_windows_timing,
                                                      window_bytes)
    from biear_tpu_torch.ops import window_gather as wg

    bank = synth.bank
    pool3, kb = bank["pool3"], bank["KB"]
    row_len = pool3.shape[1] * 128
    gen = torch.Generator(device="cuda").manual_seed(5)
    errs = {"gather_mix_kb": mix_ragged(torch, pool3), "gather_windows": 0.0}
    timing = {}
    shapes = (((TRAIN_BATCH, 125, 0, 0), (3, 61, 0, 2))
              + tuple((B, 125, ns, 0) for B, ns in RUNNER_ROWS))
    for B, nf, ns, trim in shapes:
        _, _, meas, seg_idx, qoff, crop = synth.scene_batched(gen, B, ns)
        X = meas.numel() - trim
        rows = (seg_idx * synth.n_q + qoff).reshape(-1)[:X]
        offs, meas = crop.reshape(-1)[:X], meas.reshape(-1)[:X]
        with precision_highest():
            got = wg.gather_mix_kb_cuda(pool3, rows, offs, meas, kb, nf)
            want = wg.gather_mix_kb_plain(pool3, rows, offs, meas, kb, nf)
            fw = wg.frame_windows(wg.gather_windows_plain(pool3, rows, offs)
                                  .to(kb.dtype), nf, kb.shape[1]).float()
            kx = kb[meas.long()].float()
            lib = lambda: torch.bmm(fw, kx)
            f32 = lib()
        g = wg.gather_windows_cuda(pool3, rows, offs)
        gp = wg.gather_windows_plain(pool3, rows, offs)
        torch.cuda.synchronize()
        e64 = float((got - want).abs().max())
        e32 = float((got - f32).abs().max())
        log(f"gather_mix_kb X={X} nf={nf}: max |kernel - plain (f64 sums)| "
            f"= {e64!r}, max |kernel - f32 bmm| = {e32!r} (atol {MIX_ATOL})")
        if not (e64 <= MIX_ATOL and e32 <= MIX_ATOL):
            raise RuntimeError(f"gather_mix_kb disagrees: {e64}, {e32}")
        if not torch.equal(got, wg.gather_mix_kb_cuda(pool3, rows, offs, meas,
                                                      kb, nf)):
            raise RuntimeError(f"gather_mix_kb X={X}: two launches differ")
        eg = float((g - gp).abs().max())
        if not torch.equal(g, gp):
            raise RuntimeError(f"gather_windows X={X}: not bit-exact ({eg})")
        log(f"gather_windows X={X}: bit-exact against the plain version")
        errs["gather_mix_kb"] = max(errs["gather_mix_kb"], e64)
        errs["gather_windows"] = max(errs["gather_windows"], eg)
        if B != TRAIN_BATCH:
            continue
        win_b = window_bytes(rows, offs, row_len)
        ncol = kb.shape[1]
        kb_b = 2.0 * ncol * 256 * int(torch.unique(meas).numel())
        # the synthesizer hands the wrapper int64 indices, which it casts
        # to int32 in three small launches of its own; with int32 indices
        # the wrapper launches the kernel alone
        r32, o32, m32 = (a.to(torch.int32) for a in (rows, offs, meas))
        with precision_highest():
            timing["gather_mix_kb"] = dict(
                ms=cuda_ms(lambda: wg.gather_mix_kb_cuda(pool3, r32, o32,
                                                         m32, kb, nf)),
                int64_indices_ms=cuda_ms(lambda: wg.gather_mix_kb_cuda(
                    pool3, rows, offs, meas, kb, nf)),
                plain_ms=cuda_ms(lambda: wg.gather_mix_kb_plain(
                    pool3, rows, offs, meas, kb, nf)),
                library_ms=cuda_ms(lib),
                **bound(win_b + kb_b + 12.0 * X + 4.0 * X * nf * 256,
                        2.0 * X * nf * ncol * 256, H100_BF16_FLOPS))
        log(f"mix kernel at X={X}: {timing}")

    # every X the main paths launch the window gather at (the demo's 3, the
    # runner's 192 / 63 / 66, the writer's 768, training's 1536) and the
    # shape of tools/bench_win_kernel.py (kern_chunk, kern_aligned: the
    # same gather, X = 3072), bit-exact at each and at the clamps and
    # X = 1; the floors of the same bytes at X = 1536; a misaligned pool
    # must be refused
    shapes = gather_windows_timing(torch, wg, synth)
    if not shapes["edges_and_X=1_bit_exact"]:
        raise RuntimeError("gather_windows: not bit-exact at the clamps or "
                           "at X = 1")
    if not shapes["refuses_misaligned_pool"]:
        raise RuntimeError("gather_windows launched on a pool3 view off the "
                           "16-byte grid")
    differ = [k for k, v in shapes.items()
              if k.startswith("X=") and not v["same_bits"]]
    if differ:
        raise RuntimeError(f"gather_windows: two launches differ at {differ}")
    # the kernel line's numbers at the training shape, as for the mix:
    # `ms` through the wrapper with int32 indices; `graph_ms` and
    # `cold_ms` per launch in a CUDA graph, the pool warm or cold in L2
    timing["gather_windows"] = dict(
        {k: v for k, v in shapes["X=1536"].items() if k != "same_bits"},
        by_X={k: v for k, v in shapes.items() if k.startswith("X=")},
        floors=shapes["floors X=1536"])
    for k, v in timing["gather_windows"]["by_X"].items():
        log(f"gather_windows {k}: bit-exact; {v}")
    log(f"gather_windows: bit-exact at the clamps and X = 1, a misaligned "
        f"pool refused; floors at X = 1536: {shapes['floors X=1536']}")
    return errs, timing


def snapshot(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def step_stages(torch, model, hp, batch, front=None):
    """One f32 step, no update: (loss, gradients by name, the frontend's
    outputs, their cotangents, the body's ReLU inputs). `front` (leaf
    tensors) replaces the frontend's outputs, so that the backend runs on
    given inputs."""
    from biear_tpu_torch.device import precision_highest
    from biear_tpu_torch.train.loop import active_loss

    held, relu_in = [], []

    def take(m, args, out):
        out = out if front is None else tuple(front)
        held.extend(out)
        return out
    hooks = [model.bifb.register_forward_hook(take)] + [
        model.body[i].register_forward_hook(
            lambda m, a, out: relu_in.append(out.detach().reshape(-1).cpu()))
        for i in (0, 3, 6)]
    model.train()
    names, params = zip(*model.named_parameters())
    with precision_highest():
        loss, _ = active_loss(model, hp, batch, torch.Generator(
            device=batch[0].device))
        grads = torch.autograd.grad(loss, params + tuple(held),
                                    allow_unused=True)
    for h in hooks:
        h.remove()
    k = len(params)
    return (float(loss.detach()), dict(zip(names, grads[:k])),
            [t.detach() for t in held], list(grads[k:]), torch.cat(relu_in))


def frontend_grads(torch, model, wavs, cot):
    """Gradients of the frontend's parameters under cotangents `cot` of its
    outputs, on waveforms `wavs` (sanitised as the train step does)."""
    from biear_tpu_torch.device import precision_highest
    from biear_tpu_torch.train.losses import sanitize_wav
    names, params = zip(*[(n, p) for n, p in model.named_parameters()
                          if n.startswith("bifb.")])
    model.train()
    with precision_highest():
        out = model.bifb(*sanitize_wav(*wavs), torch.Generator(), True)
        return out, dict(zip(names, torch.autograd.grad(out, params, cot)))


def rel_l2(torch, a, b):
    """Relative L2 distance of tensor lists (or name -> tensor dicts) a
    from b, over the keys of b that are not None."""
    keys = list(b) if isinstance(b, dict) else range(len(b))
    keys = [k for k in keys if b[k] is not None]
    x = torch.cat([a[k].cpu().reshape(-1) for k in keys])
    y = torch.cat([b[k].cpu().reshape(-1) for k in keys])
    return float((x - y).norm() / y.norm())


def spectra_of(torch, cfg, wavs):
    """Real and imaginary spectra of both ears' waveforms, flattened, on
    the CPU."""
    from biear_tpu_torch.device import precision_highest
    from biear_tpu_torch.models.frontend import device_constants, spectra
    c = device_constants(cfg, wavs[0].device)
    with precision_highest():
        return torch.cat([x.reshape(-1).cpu() for w in wavs
                          for x in spectra(cfg, w, c)[1:]])


def step_card_vs_cpu(torch, hp, cfg, batch, label):
    """One f32 step on the card against the CPU port (same weights, same
    batch), stage by stage; see STEP_LOSS_ATOL. Raises on disagreement."""
    from biear_tpu_torch.models import build_active
    from biear_tpu_torch.models.backend import ipd_features

    cb = tuple(b.cpu() for b in batch)
    gpu = build_active(cfg, seed=3)
    cpu = build_active(cfg, seed=3, device="cpu")
    lg, gg, fg, cg, rg = step_stages(torch, gpu, hp, batch)
    lc, gc, fc, _, rc = step_stages(torch, cpu, hp, cb)
    dl = abs(lg - lc)
    fcard = [f.cpu().requires_grad_() for f in fg]
    _, gb, _, cb_cot, _ = step_stages(torch, cpu, hp, cb, front=fcard)
    back = [n for n in gb if not n.startswith("bifb.")]
    d_back = rel_l2(torch, gg, {n: gb[n] for n in back})
    d_cot = rel_l2(torch, cg, cb_cot)
    cot = [c.cpu() for c in cg]
    front = [n for n in gg if n.startswith("bifb.")]
    _, gf = frontend_grads(torch, cpu, cb[:2], cot)
    d_front = rel_l2(torch, gg, gf)

    # witness noise: white, per waveform row in units of its rms, scaled
    # (linear in the noise) to the card's distance from the CPU's spectra
    rel = lambda a, b: float((a - b).norm() / b.norm())
    spec = spectra_of(torch, cfg, cb[:2])
    d_spec = rel(spectra_of(torch, cfg, batch[:2]), spec)
    noise = torch.Generator().manual_seed(7)
    unit = lambda w: (w.pow(2).mean(-1, keepdim=True).sqrt()
                      * torch.randn(w.shape, generator=noise))
    probe = 1e-5
    eps = probe * d_spec / rel(spectra_of(
        torch, cfg, [w + probe * unit(w) for w in cb[:2]]), spec)
    spread = max(rel_l2(torch, frontend_grads(
        torch, cpu, [w + eps * unit(w) for w in cb[:2]], cot)[1], gf)
        for _ in range(WITNESS_DRAWS))
    limit = WITNESS_FACTOR * spread

    wraps = int(((ipd_features(fg[4], fg[5]).cpu()
                  - ipd_features(fc[4], fc[5])).abs() > 3.0).sum())
    whole = {g: rel_l2(torch, gg, {n: gc[n] for n in names})
             for g, names in (("frontend", front), ("backend", back))}
    log(f"B=4 f32 step on the {label} batch, card vs CPU: loss {lg!r} vs "
        f"{lc!r} (|d| {dl!r}, atol {STEP_LOSS_ATOL}); backend on the card's "
        f"frontend outputs: gradients {d_back!r}, cotangents {d_cot!r} "
        f"(limit {BACKEND_RTOL}); frontend under the card's cotangents: "
        f"gradients {d_front!r} (limit {limit!r}: CPU's own spread "
        f"{spread!r} under waveform noise {eps!r} rms, {WITNESS_DRAWS} "
        f"draws; spectra {d_spec!r})")
    log(f"  whole gradients (not compared): {whole!r}; IPD values across "
        f"the +-pi wrap {wraps}, body ReLU inputs of opposite sign "
        f"{int(((rg > 0) != (rc > 0)).sum())} of {rc.numel()}")
    if not (dl <= STEP_LOSS_ATOL and d_back <= BACKEND_RTOL
            and d_cot <= BACKEND_RTOL and d_front <= limit):
        raise RuntimeError(f"train step on the {label} batch: card and CPU "
                           "disagree")


def train_chunk_phase(torch, synth, label: str, steps: int):
    """A fused chunk of `steps` synthesize -> train steps of the geometry
    ``profile_serve.GEOMETRY[label]`` at
    TRAIN_BATCH, bf16: one mix and one CC launch per step, finite losses,
    nothing skipped, finite non-zero gradient norms, both groups and every
    controller's zero-initialised output layer moved; then the fused and
    bare-step rates. Returns the chunk's launch counts."""
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.graph import WARMUP_STEPS
    from biear_tpu_torch.train.loop import make_train_chunk, make_train_step
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer
    from biear_tpu_torch.serve.profile_serve import GEOMETRY
    from biear_tpu_torch.train.profile_train import fixed_batch, rate_windows

    geometry = GEOMETRY[label]

    hp = TrainHyper()
    cfg = BiEARConfig(**geometry, fb_w_dtype="bfloat16")
    model = build_active(cfg, seed=0)
    opt = make_optimizer(model, hp)
    chunk = make_train_chunk(model, hp, opt, synth.batch_fn(TRAIN_BATCH),
                             steps)
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = snapshot(model)

    LAUNCHES.clear()
    ms = chunk(gen)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"{label} train chunk ({steps} steps, B={TRAIN_BATCH}, bf16) "
        f"launches: {launches}")
    for k in ("gather_mix_kb", "cc_lags"):
        # the first call captures: WARMUP_STEPS eager steps, then replays
        if launches.get(k, 0) != steps + WARMUP_STEPS:
            raise RuntimeError(f"{label}: {k} launched {launches.get(k, 0)} "
                               f"times in {WARMUP_STEPS} warm-up and {steps} "
                               "train steps")
    losses = ms["loss"].tolist()
    log(f"{label} train losses {losses!r}, skipped {ms['skipped'].tolist()}")
    log(f"{label} grad norms: frontend {ms['grad_fb_norm'].tolist()!r}, "
        f"backend {ms['grad_backend_norm'].tolist()!r}")
    if not all(np.isfinite(losses)) or float(ms["skipped"].sum()) != 0:
        raise RuntimeError(f"{label} train chunk: nonfinite loss or skipped "
                           "step")
    for k in ("grad_fb_norm", "grad_backend_norm"):
        v = ms[k]
        if not (bool(torch.isfinite(v).all()) and float(v.min()) > 0):
            raise RuntimeError(f"{label} train chunk: {k} = {v.tolist()}")
    after = snapshot(model)
    moved = {n: float((after[n] - before[n]).abs().max()) for n in before}
    fe = max(v for n, v in moved.items() if n.startswith("bifb."))
    be = max(v for n, v in moved.items() if not n.startswith("bifb."))
    out_layers = [n for n in after if n.endswith("q_out.8.weight")]
    out_layer = min(float(after[n].abs().max()) for n in out_layers)
    log(f"{label} max parameter change: frontend {fe!r}, backend {be!r}; "
        f"controller output layers {out_layers} (zero at start) min max |w| "
        f"{out_layer!r}")
    if not (fe > 0 and be > 0 and out_layers and out_layer > 0):
        raise RuntimeError(f"{label} train chunk: a parameter group did not "
                           "move")

    fused = rate_windows(lambda: chunk(gen), TRAIN_BATCH * steps, 3)
    fb = fixed_batch(TRAIN_BATCH, cfg.n_bands, 0, "cuda")
    step = make_train_step(model, hp, opt)
    step(fb, gen)
    bare = rate_windows(lambda: [step(fb, gen) for _ in range(steps)],
                        TRAIN_BATCH * steps, 3)
    log(f"{label} train B={TRAIN_BATCH} bf16: fused pipeline "
        f"{fused['median']!r} utterances/s [{fused['min']!r}-"
        f"{fused['max']!r}], bare step {bare['median']!r} utterances/s "
        f"[{bare['min']!r}-{bare['max']!r}] (windows of {steps} steps)")
    return launches


def phase_train(torch, synth):
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.graph import WARMUP_STEPS
    from biear_tpu_torch.train.loop import make_train_chunk
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer
    from biear_tpu_torch.serve.profile_serve import GEOMETRY
    from biear_tpu_torch.train.profile_train import fixed_batch

    launches = {"train_bf16": train_chunk_phase(torch, synth, "dual",
                                                TRAIN_STEPS)}
    hp = TrainHyper()
    gen = torch.Generator(device="cuda").manual_seed(1)

    # f32 policy, smaller batch: the window-gather kernel
    cfg32 = BiEARConfig(**GEOMETRY["dual"], fb_w_dtype="float32")
    m32 = build_active(cfg32, seed=0)
    synth32 = training_synth(torch, "float32")
    chunk32 = make_train_chunk(m32, hp, make_optimizer(m32, hp),
                               synth32.batch_fn(64), 1)
    LAUNCHES.clear()
    ms32 = chunk32(gen)
    torch.cuda.synchronize()
    launches["train_f32"] = dict(LAUNCHES)
    log(f"train step (B=64, f32) launches: {launches['train_f32']}, loss "
        f"{float(ms32['loss'][0])!r}")
    if (LAUNCHES.get("gather_windows", 0) != 1 + WARMUP_STEPS
            or LAUNCHES.get("gather_mix_kb", 0) != 0
            or not bool(torch.isfinite(ms32["loss"]).all())
            or float(ms32["skipped"].sum()) != 0):
        raise RuntimeError("f32 train step: wrong kernels or bad loss")

    # one step on the card against the CPU port: a synthesised batch (the
    # generator's state here is fixed by the seed and the step above) and
    # bench.py's white-noise batch
    cfg0 = BiEARConfig(**GEOMETRY["dual"], fb_w_dtype="float32",
                       ctrl_dropout=0.0, backend_dropout=0.0)
    step_card_vs_cpu(torch, hp, cfg0, synth32.sample_batch(gen, 4),
                     "synthesised")
    step_card_vs_cpu(torch, hp, cfg0, fixed_batch(4, cfg0.n_bands, 0, "cuda"),
                     "white-noise")
    return launches


def stream_hop_ms(torch, model, batch: int, reps: int = 10) -> float:
    """Median host time of one synchronised stream_step at `batch`."""
    from biear_tpu_torch.serve.profile_stream import Streams, host_ms
    return statistics.median(host_ms(Streams(model, batch, False), reps))


def phase_stream(torch, rng):
    """stream_apply against the forward on the same crop (dual, single,
    fixed-Q; f32 and bf16 with the matmul DFT), the churn check, per-hop
    times. Returns the launch counts of the streamed runs alone."""
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.ops.xcorr import cross_correlation_feature
    from biear_tpu_torch.serve.profile_serve import GEOMETRY
    from biear_tpu_torch.serve.streaming import (stream_apply, stream_init,
                                                 stream_plan, stream_readout,
                                                 stream_reset, stream_step)

    B = STREAM_BATCH
    wavL, wavR = (torch.tensor(rng.uniform(-1, 1, (B, 16000)),
                               dtype=torch.float32, device="cuda")
                  for _ in range(2))
    launches = {}
    models = {}
    for (mode, fixed, dt) in (("dual", False, "float32"),
                              ("single", False, "float32"),
                              ("dual", True, "float32"),
                              ("dual", False, "bfloat16"),
                              ("single", False, "bfloat16"),
                              ("dual", True, "bfloat16")):
        cfg = BiEARConfig(**GEOMETRY[mode], fixed_frontend_q=fixed,
                          fb_w_dtype=dt,
                          dft_mode="matmul" if dt == "bfloat16" else "fft")
        model = build_active(cfg, seed=0)
        perturb_controllers(torch, model, seed=1)
        label = f"{mode}{' fixed-Q' if fixed else ''} {dt}"
        models[label] = model
        with torch.inference_mode():
            x3 = cross_correlation_feature(wavL, wavR, cfg.fs)
            want = model(wavL, wavR, x3)[:3]
        LAUNCHES.clear()
        got = stream_apply(model, wavL, wavR)
        torch.cuda.synchronize()
        launches[label] = dict(LAUNCHES)
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        log(f"stream {label} B={B}: max |stream_apply - forward| (sound, "
            f"aoa, dist) = {errs!r} (atol {STREAM_ATOL}); launches of the "
            f"port's kernels while streaming: {launches[label]}")
        if not max(errs) <= STREAM_ATOL:
            raise RuntimeError(f"stream {label}: differs from the forward")

    # churn: reset half the slots after 9 hops, feed 10 more; the reset
    # slots must equal fresh streams fed the same audio, bit for bit
    for label in ("dual float32", "single bfloat16"):
        model = models[label]
        hop = stream_plan(model.cfg)["hop"]

        def hops(state, t0, n):
            for t in range(t0, t0 + n):
                sl = slice(t * hop, (t + 1) * hop)
                state = stream_step(model, state, wavL[:, sl], wavR[:, sl])
            return state

        mask = torch.arange(B, device="cuda") % 2 == 0
        churned = stream_reset(model, hops(stream_init(model, B), 0, 9), mask)
        got = stream_readout(model, hops(churned, 9, 10))
        ref = stream_readout(model, hops(stream_init(model, B), 9, 10))
        same = all(torch.equal(g[mask], r[mask]) for g, r in zip(got, ref))
        log(f"stream churn {label}: {int(mask.sum())} slots reset after 9 "
            f"hops equal fresh streams bit for bit: {same}")
        if not same:
            raise RuntimeError(f"stream churn {label}: reset slots differ "
                               "from fresh streams")

    for label in ("dual bfloat16", "single bfloat16"):
        t1, t512 = (stream_hop_ms(torch, models[label], b) for b in (1, 512))
        log(f"stream {label}: stream_step host p50 {t1!r} ms per hop at "
            f"batch 1, {t512!r} ms at batch 512 (hop 52.625 ms)")
    total = {}
    for c in launches.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


class Jittered:
    """A dataset whose input fields (all but the label) carry relative
    noise of `rel` rms: the rounding-level witness of a trained
    checkpoint's own spread (tests/test_torch_port_evaluate.py)."""

    def __init__(self, ds, rel: float, seed: int):
        self.ds, self.rel = ds, rel
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.ds)

    def rows(self, idx):
        r = list(self.ds.rows(idx))
        for i in range(len(r) - 1):
            noise = 1 + self.rel * self.rng.standard_normal(r[i].shape)
            r[i] = (r[i] * noise).astype(np.float32)
        return tuple(r)


def compare_evaluations(torch, label, ckpt, settings, shard, tmp, tol,
                        witness: bool):
    """``evaluate`` of a checkpoint on a shard, on the card, against the
    CPU port's predictions on the same shard: rows equal except where a
    presence logit lies within the row's tolerance of 0 or a distance
    top-2 margin within twice it; over all rows the card's accuracies
    differ from the CPU's by no more than the flipped presence / distance
    decisions; MAE to 1e-4. The row's tolerance is `tol`, or with
    `witness` the larger of `tol` and the CPU's own change of the row's
    logits under 1e-6 relative input noise (a trained checkpoint's
    forward is ill-conditioned at the rounding level). Returns the
    evaluation's launch counts."""
    from biear_tpu_torch.data.shard import ShardDataset
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.train import evaluate as ev
    from biear_tpu_torch.config import family
    from biear_tpu_torch.data.shard import shard_shapes

    cfg = ev.config_from_settings(settings)
    kind = family(settings)
    passive = kind == "passive"
    LAUNCHES.clear()
    m_card = ev.evaluate(ckpt, settings=settings, test_shard=shard,
                         out_path=os.path.join(tmp, f"{label}-card.json"))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    ds = ShardDataset(shard, shard_shapes(cfg, passive))
    card = ev.collect_predictions(ev.load_model(ckpt, cfg, kind=kind), ds,
                                  64)
    cpu_model = ev.load_model(ckpt, cfg, "cpu", kind=kind)
    cpu = ev.collect_predictions(cpu_model, ds, 64)
    m_cpu = ev.metrics_from_predictions(*cpu)
    if m_card != ev.metrics_from_predictions(*card):
        raise RuntimeError(f"{label}: evaluate's metrics differ from those "
                           "of its own predictions")
    spread = np.zeros(cpu[0].shape[0])
    if witness:
        wit = ev.collect_predictions(cpu_model, Jittered(ds, 1e-6, 5), 64)
        spread = np.maximum(np.abs(wit[0] - cpu[0]).max(1),
                            np.abs(wit[2] - cpu[2]).max((1, 2)))
    row_tol = np.maximum(tol, spread)[:, None]
    diff = max(float(np.abs(a - b).max()) for a, b in zip(card[:3], cpu[:3]))
    # per (row, sector): presence flips only where the CPU's logit is
    # within the row's tolerance of 0, distance flips only where its top-2
    # margin is within twice it (each logit may move by the tolerance)
    top2 = np.sort(cpu[2], axis=-1)[..., -2:]
    flip_el = np.concatenate([(card[0] > 0) != (cpu[0] > 0),
                              card[2].argmax(-1) != cpu[2].argmax(-1)], 1)
    near_el = np.concatenate([np.abs(cpu[0]) <= row_tol,
                              top2[..., 1] - top2[..., 0] <= 2 * row_tol], 1)
    flipped = flip_el.any(1)
    near = near_el.any(1)
    # all rows: each flipped decision moves its accuracy by 1 / (rows x 8)
    n_el = cpu[0].size
    d_acc = {k: abs(m_card["overall"][k] - m_cpu["overall"][k]) * n_el
             for k in ("sound_acc", "dist_acc")}
    n_flip = {"sound_acc": int(flip_el[:, :8].sum()),
              "dist_acc": int(flip_el[:, 8:].sum())}
    d_mae = abs(m_card["overall"]["aoa_mae"] - m_cpu["overall"]["aoa_mae"])
    log(f"{label} card vs CPU: max |logit or aoa difference| {diff!r}; "
        f"CPU's own spread under 1e-6 input noise max {float(spread.max())!r}"
        f" (witness {witness}); rows with a different prediction "
        f"{int(flipped.sum())} (each within its row's tolerance, at least "
        f"{tol}, of its boundary: {not (flip_el & ~near_el).any()}; rows "
        f"near a boundary {int(near.sum())}); accuracies (sound, dist) "
        f"{m_card['overall']['sound_acc']!r} / "
        f"{m_card['overall']['dist_acc']!r} (card) and "
        f"{m_cpu['overall']['sound_acc']!r} / "
        f"{m_cpu['overall']['dist_acc']!r} (CPU), decisions apart "
        f"{d_acc!r} against flipped {n_flip}; |d MAE| {d_mae!r}")
    log(f"{label} card metrics: {json.dumps(m_card['overall'])}")
    if ((flip_el & ~near_el).any()
            or any(round(d_acc[k]) > n_flip[k] for k in d_acc)
            or not d_mae <= 1e-4 or set(m_card) != set(m_cpu)):
        raise RuntimeError(f"{label}: card and CPU disagree")
    return launches


def phase_evaluate(torch, synth):
    """A synthesised shard evaluated on the card and on the CPU."""
    import tempfile
    from biear_tpu_torch.data.shard import write_shard
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.serve.profile_serve import GEOMETRY

    settings = {"Active": True, "MODEL_KIND": "active", "USE_CC": True,
                "Controller_Mode": "single", "DELTAQ_MODE": "absolute",
                "DELTAQ_BASE": 2.0, "DELTAQ_LOW_FACTOR": 0.5,
                "DELTAQ_HIGH_FACTOR": 5.0,
                "GEOMETRY": {"FB_W_DTYPE": "bfloat16"}}
    with tempfile.TemporaryDirectory() as tmp:
        LAUNCHES.clear()
        batch = synth.sample_batch(torch.Generator(device="cuda")
                                   .manual_seed(3), EVAL_ROWS)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        shard = os.path.join(tmp, "test.shard")
        write_shard(shard, [a.cpu().numpy() for a in batch],
                    ["i16", "i16", "f32", "f32"])
        model = build_active(BiEARConfig(**GEOMETRY["single"],
                                         fb_w_dtype="bfloat16"), seed=4)
        perturb_controllers(torch, model, seed=5)
        ckpt = os.path.join(tmp, "run", "best.pth")
        os.makedirs(os.path.dirname(ckpt))
        torch.save(model.state_dict(), ckpt)
        with open(os.path.join(tmp, "run", "settings.json"), "w") as f:
            json.dump(settings, f)
        ev_launches = compare_evaluations(
            torch, "evaluate", ckpt, settings, shard, tmp,
            SERVE_TOL["bfloat16"], witness=False)
    for k, v in ev_launches.items():
        launches[k] = launches.get(k, 0) + v
    log(f"evaluate: {EVAL_ROWS}-row shard synthesised on the card; launches "
        f"(synthesis and the card's evaluation): {launches}")
    return launches


def synth_eval_batches(n: int, batch: int) -> tuple:
    """Batches of a val split and of a test split split into source-count
    thirds (``train.runner.SynthEvalDataset``)."""
    third, made, test = n // 3, 0, 0
    while made < n:
        boundary = (third if made < third
                    else 2 * third if made < 2 * third else n)
        made += min(batch, n - made, boundary - made)
        test += 1
    return -(-n // batch), test


def phase_runner(torch):
    """The training runner on the card: 2 epochs, a resume, evaluate."""
    import tempfile
    from biear_tpu_torch import train_biear
    from biear_tpu_torch.data.shard import write_shard
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.models import ActiveBiEAR
    from biear_tpu_torch.train import evaluate as ev
    from biear_tpu_torch.train import state as ckpt
    from biear_tpu_torch.train.loop import make_train_chunk
    from biear_tpu_torch.train.optim import make_optimizer
    from biear_tpu_torch.graph import WARMUP_STEPS
    from biear_tpu_torch.train.profile_train import rate_windows
    from biear_tpu_torch.train.runner import train

    rc = synthesised_run_config("config.yaml", 2)
    B = rc.batch_size
    m = rc.model_cfg
    log(f"runner: conf/config.yaml, {m.controller_mode} controllers, "
        f"{m.deltaQ_mode} deltaQ, {m.n_bands} bands, {m.timesteps} frames, "
        f"batch {B}, FB_W_DTYPE {m.fb_w_dtype}")
    synth = train_biear.make_synth(rc)
    with tempfile.TemporaryDirectory() as tmp:
        rc.runs_root = tmp
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        first = train(rc, synth=synth, run_id="smoke", quiet=True)
        rc.epochs = 3
        out = train(rc, synth=synth, quiet=True,
                    resume_from=first["run_dir"])
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        run = out["run_dir"]
        log(f"runner launches (2 epochs and a resume): {launches}")
        val_b, test_b = synth_eval_batches(RUNNER_EVAL, B)
        # each train call captures its chunk: WARMUP_STEPS eager steps
        want = 3 * RUNNER_STEPS + 2 * (1 + val_b + test_b + WARMUP_STEPS)
        for k in ("cc_lags", "gather_windows"):
            if launches.get(k, 0) != want:
                raise RuntimeError(f"runner: {k} launched "
                                   f"{launches.get(k, 0)} times, not {want}")
        if launches.get("gather_mix_kb", 0):
            raise RuntimeError("runner: the bf16 mix ran under the f32 policy")

        hist = check_run_tree(run, "runner")
        losses = [e["loss"] for split in ("train", "val")
                  for e in hist[split]]
        if (len(hist["train"]) != 3 or len(hist["val"]) != 3
                or not all(np.isfinite(losses))
                or any(e["skipped"] for e in hist["train"])
                or out["global_step"] != 3 * RUNNER_STEPS):
            raise RuntimeError(f"runner: history {hist}, global_step "
                               f"{out['global_step']}")
        log(f"runner history: train losses "
            f"{[e['loss'] for e in hist['train']]!r}, val losses "
            f"{[e['loss'] for e in hist['val']]!r}, global_step "
            f"{out['global_step']}, test {out['test']}")

        # `last` restores to the bits of the model and optimizer in memory
        fresh = ActiveBiEAR(rc.model_cfg).cuda()
        fopt = make_optimizer(fresh, rc.hyper)
        ckpt.load_checkpoint(os.path.join(run, "checkpoints", "last"),
                             fresh, fopt)
        same = all(torch.equal(v, fresh.state_dict()[k])
                   for k, v in out["model"].state_dict().items())
        sa, sb = out["optimizer"].state_dict(), fopt.state_dict()
        same = same and all(
            torch.equal(sa[g]["count"], sb[g]["count"])
            and all(torch.equal(sa[g][key][n], sb[g][key][n])
                    for key in ("m", "v") for n in sa[g][key])
            for g in sa)
        log(f"runner: 'last' restores to the in-memory state bit for bit: "
            f"{same}")
        if not same:
            raise RuntimeError("runner: 'last' differs from the final state")

        # evaluate the run's best on a shard synthesised on the card
        batch = synth.sample_batch(torch.Generator(device="cuda")
                                   .manual_seed(9), EVAL_ROWS)
        shard = os.path.join(tmp, "test.shard")
        write_shard(shard, [a.cpu().numpy() for a in batch],
                    ["i16", "i16", "f32", "f32"])
        res = ev.evaluate(os.path.join(run, "checkpoints", "best"),
                          test_shard=shard,
                          out_path=os.path.join(tmp, "eval.json"))
        o = res["overall"]
        if not ({"overall", "1spk", "2spk", "3spk"} <= set(res)
                and all(0.0 <= o[k] <= 1.0 for k in ("sound_acc", "dist_acc"))
                and np.isfinite(o["aoa_mae"])):
            raise RuntimeError(f"runner: evaluate of best gave {res}")
        log(f"runner: evaluate of checkpoints/best on {EVAL_ROWS} rows: "
            f"{json.dumps(o)}")

    # the runner's training rate against the bare fused chunk, same call
    epoch_s = [t["sec"] + v["sec"] for t, v in zip(hist["train"],
                                                    hist["val"])]
    runner_utt_s = [RUNNER_STEPS * B / t["sec"] for t in hist["train"]]
    model = ActiveBiEAR(rc.model_cfg).init_weights_(1).cuda()
    chunk = make_train_chunk(model, rc.hyper, make_optimizer(model, rc.hyper),
                             synth.batch_fn(B), RUNNER_CHUNK)
    gen = torch.Generator(device="cuda").manual_seed(2)
    chunk(gen)
    bare = rate_windows(lambda: chunk(gen), B * RUNNER_CHUNK, 3)
    ck_ms = [1e3 * t for r in (first, out) for t in r["timings"]["checkpoint_s"]]
    split_ms = [1e3 * r["timings"]["eval_splits_s"] for r in (first, out)]
    metrics = {"epoch_s": epoch_s, "runner_train_utt_s": runner_utt_s,
               "bare_chunk_utt_s": bare, "checkpoint_write_ms": ck_ms,
               "eval_splits_ms": split_ms, "peak_memory_bytes": peak,
               "wall_s": wall}
    log(f"runner metrics (B={B}, f32): {json.dumps(metrics)}")
    return launches, metrics


def check_run_tree(run: str, label: str) -> dict:
    """The run tree's files exist; returns history.json."""
    for rel in ("meta/settings.json", "logs_json/history.json",
                "logs_json/scalars.jsonl", "logs_json/test_metrics.json",
                "checkpoints/best/params.pth",
                "checkpoints/best/opt_state.pt",
                "checkpoints/last/params.pth",
                "checkpoints/last/opt_state.pt"):
        if not os.path.isfile(os.path.join(run, rel)):
            raise RuntimeError(f"{label}: {rel} missing from the run tree")
    with open(os.path.join(run, "logs_json", "history.json")) as f:
        return json.load(f)


def synthesised_run_config(name: str, epochs: int):
    """conf/<name> as written, synthesised on the card with RUNNER_STEPS
    steps per epoch in chunks of RUNNER_CHUNK and eval splits of
    RUNNER_EVAL rows."""
    from biear_tpu_torch.config import load_run_config
    here = os.path.dirname(os.path.abspath(__file__))
    rc = load_run_config(os.path.join(here, "conf", name))
    rc.synth_on_device, rc.epochs = True, epochs
    rc.raw = dict(rc.raw, SYNTH_ON_DEVICE=True,
                  SYNTH_STEPS_PER_EPOCH=RUNNER_STEPS,
                  SYNTH_CHUNK_STEPS=RUNNER_CHUNK,
                  SYNTH_EVAL_SAMPLES=RUNNER_EVAL)
    return rc


def runner_phase(torch, name: str, epochs: int, label: str,
                 runs_root: str | None = None):
    """``train.runner.train`` of a synthesised run config on the card:
    launch counts (one CC and, on the anechoic fast path, one window
    gather per training step and per synthesised eval or sanity batch, no
    bf16 mix), the run tree, finite losses, nothing skipped; seconds per
    epoch and utt/s logged. The run goes to a temporary directory, or
    stays under `runs_root`. Returns (launches, the run config, its
    synthesizer)."""
    import tempfile
    from biear_tpu_torch import train_biear
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.config import is_passive
    from biear_tpu_torch.graph import WARMUP_STEPS
    from biear_tpu_torch.train.runner import train

    rc = synthesised_run_config(name, epochs)
    B = rc.batch_size
    m = rc.model_cfg
    synth = train_biear.make_synth(rc)
    inner = getattr(synth, "inner", synth)
    fast = bool(getattr(inner, "fast", False))
    kind = "passive" if is_passive(rc) else m.controller_mode
    scene = rc.raw.get("SCENE", "anechoic")
    log(f"{label}: conf/{name}, {kind} model, scene {scene}, {m.n_bands} "
        f"bands, {m.timesteps} frames, batch {B}, FB_W_DTYPE {m.fb_w_dtype}, "
        f"synthesizer {type(synth).__name__}({type(inner).__name__})")
    with tempfile.TemporaryDirectory() as tmp:
        rc.runs_root = runs_root or tmp
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out = train(rc, synth=synth, run_id="smoke", quiet=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        hist = check_run_tree(out["run_dir"], label)
    val_b, test_b = synth_eval_batches(RUNNER_EVAL, B)
    want = epochs * RUNNER_STEPS + 1 + val_b + test_b + WARMUP_STEPS
    log(f"{label} launches ({epochs} epochs): {launches}; expected {want} "
        f"of cc_lags{' and gather_windows' if fast else ''}")
    if (launches.get("cc_lags", 0) != want
            or launches.get("gather_windows", 0) != (want if fast else 0)
            or launches.get("gather_mix_kb", 0)):
        raise RuntimeError(f"{label}: wrong kernel launches {launches}")
    losses = [e["loss"] for split in ("train", "val") for e in hist[split]]
    if (len(hist["train"]) != epochs or not all(np.isfinite(losses))
            or any(e["skipped"] for e in hist["train"])
            or out["global_step"] != epochs * RUNNER_STEPS
            or not np.isfinite(out["test"]["loss"])):
        raise RuntimeError(f"{label}: history {hist}")
    metrics = {"epoch_s": [t["sec"] + v["sec"] for t, v in
                           zip(hist["train"], hist["val"])],
               "runner_train_utt_s": [RUNNER_STEPS * B / t["sec"]
                                      for t in hist["train"]],
               "train_losses": [e["loss"] for e in hist["train"]],
               "val_losses": [e["loss"] for e in hist["val"]],
               "eval_splits_ms": 1e3 * out["timings"]["eval_splits_s"],
               "checkpoint_write_ms": [1e3 * t for t in
                                       out["timings"]["checkpoint_s"]],
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "wall_s": wall}
    log(f"{label} metrics (B={B}): {json.dumps(metrics)}")
    return launches, rc, synth


def protocol_shard_evaluation(torch, synth, kind: str, tmp: str):
    """docs/protocol_r3/<kind>/best.pth evaluated on an EVAL_ROWS-row shard
    that `synth` makes on the card (waveforms as int16, features as f32),
    card against CPU with the witness (compare_evaluations). Returns the
    evaluation's launch counts."""
    from biear_tpu_torch.data.shard import write_shard

    here = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(here, "docs", "protocol_r3", kind, "best.pth")
    with open(os.path.join(os.path.dirname(ckpt), "settings.json")) as f:
        settings = json.load(f)
    batch = synth.sample_batch(torch.Generator(device="cuda").manual_seed(9),
                               EVAL_ROWS)
    shard = os.path.join(tmp, f"{kind}.shard")
    arrays = [a.cpu().numpy() for a in batch]
    write_shard(shard, arrays, (["i16", "i16", "f32", "f32"]
                                if len(arrays) == 4 else None))
    tol = SERVE_TOL[settings.get("GEOMETRY", {}).get("FB_W_DTYPE",
                                                     "float32")]
    return compare_evaluations(torch, f"evaluate {kind}", ckpt, settings,
                               shard, tmp, tol, witness=True)


def phase_passive(torch, synth_bf16):
    """Phase 11: the passive family at full width: features card vs CPU,
    a fused chunk at TRAIN_BATCH (bf16 mix), the runner on
    conf/config_passive.yaml, docs/protocol_r3/passive/best.pth
    evaluated card vs CPU."""
    import tempfile
    from biear_tpu_torch.data.passive_synth import PassiveFeatureSynth
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.models import BiEARConfig, build_passive
    from biear_tpu_torch.ops.features import passive_features
    from biear_tpu_torch.graph import WARMUP_STEPS
    from biear_tpu_torch.train.loop import make_train_chunk, make_train_step
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer
    from biear_tpu_torch.train.profile_train import rate_windows

    launches = {}
    # (a) features on the card against the CPU port
    wav = synth_bf16.sample_batch(torch.Generator(device="cuda")
                                  .manual_seed(8), FEATURE_BATCH)[0]
    mag, ph = (a.cpu() for a in passive_features(wav))
    cmag, cph = passive_features(wav.cpu())
    strong = cmag > -60.0
    e_mag = float((mag - cmag)[strong].abs().max())
    d = torch.remainder(ph.double() - cph.double() + np.pi, 2 * np.pi) - np.pi
    e_ph = float(d[strong].abs().max())
    pad = bool((mag[:, 18:] == -80.0).all())
    feat_ms = cuda_ms(lambda: passive_features(wav))
    log(f"passive features B={FEATURE_BATCH} card vs CPU above -60 dB "
        f"({float(strong.float().mean())!r} of the values): magnitude "
        f"{e_mag!r} dB (limit {FEATURE_DB_TOL!r}), wrapped phase {e_ph!r} rad"
        f" (limit {FEATURE_RAD_TOL}); padded frame -80: {pad}; "
        f"{feat_ms!r} ms per ear on the card")
    if not (e_mag <= FEATURE_DB_TOL and e_ph <= FEATURE_RAD_TOL and pad):
        raise RuntimeError("passive features: card and CPU disagree")

    # (b) the fused passive chunk at TRAIN_BATCH, bf16 mix
    psynth = PassiveFeatureSynth(synth_bf16)
    hp = TrainHyper()
    model = build_passive(BiEARConfig(), seed=0)
    opt = make_optimizer(model, hp)
    chunk = make_train_chunk(model, hp, opt, psynth.batch_fn(TRAIN_BATCH),
                             TRAIN_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = snapshot(model)
    LAUNCHES.clear()
    ms = chunk(gen)
    torch.cuda.synchronize()
    launches["passive_train_bf16"] = dict(LAUNCHES)
    losses = ms["loss"].tolist()
    log(f"passive train chunk ({TRAIN_STEPS} steps, B={TRAIN_BATCH}, bf16 "
        f"mix) launches: {launches['passive_train_bf16']}; losses "
        f"{losses!r}, skipped {ms['skipped'].tolist()}")
    if (LAUNCHES.get("gather_mix_kb", 0) != TRAIN_STEPS + WARMUP_STEPS
            or LAUNCHES.get("cc_lags", 0) != TRAIN_STEPS + WARMUP_STEPS
            or LAUNCHES.get("gather_windows", 0)
            or not all(np.isfinite(losses))
            or float(ms["skipped"].sum()) != 0):
        raise RuntimeError("passive train chunk: wrong kernels, nonfinite "
                           "loss or skipped step")
    moved = max(float((p - before[n]).abs().max())
                for n, p in snapshot(model).items())
    if not moved > 0:
        raise RuntimeError("passive train chunk: the parameters did not move")
    fused = rate_windows(lambda: chunk(gen), TRAIN_BATCH * TRAIN_STEPS, 3)
    fb = psynth.sample_batch(gen, TRAIN_BATCH)
    step = make_train_step(model, hp, opt)
    step(fb, gen)
    bare = rate_windows(lambda: [step(fb, gen) for _ in range(TRAIN_STEPS)],
                        TRAIN_BATCH * TRAIN_STEPS, 3)
    log(f"passive train B={TRAIN_BATCH}: fused pipeline {fused['median']!r} "
        f"utterances/s [{fused['min']!r}-{fused['max']!r}], bare step "
        f"{bare['median']!r} utterances/s [{bare['min']!r}-{bare['max']!r}] "
        f"(windows of {TRAIN_STEPS} steps)")

    # (c) the runner on conf/config_passive.yaml, synthesised (f32 mix)
    launches["passive_runner"], _, rsynth = runner_phase(
        torch, "config_passive.yaml", 2, "passive runner")
    # (d) the protocol's passive checkpoint on a shard made on the card
    with tempfile.TemporaryDirectory() as tmp:
        LAUNCHES.clear()
        launches["passive_evaluate"] = protocol_shard_evaluation(
            torch, rsynth, "passive", tmp)
    return launches


def phase_reverb(torch):
    """Phase 12: the reverberant scenes and the general anechoic path at
    full width: spirit and auditorium batches card vs CPU, the runner on
    conf/config_spirit.yaml, a flagship chunk on a 1.2 s pool,
    docs/protocol_r3/spirit/best.pth evaluated card vs CPU."""
    import tempfile
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            build_synthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.serve.profile_serve import GEOMETRY
    from biear_tpu_torch.graph import WARMUP_STEPS
    from biear_tpu_torch.train.loop import make_train_chunk
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer
    from biear_tpu_torch.train.profile_train import rate_windows

    launches = {}
    segs = make_test_segments(64)
    gen = torch.Generator(device="cuda").manual_seed(6)
    # (a) reverberant batches on the card against the CPU port
    for scene in ("spirit", "auditorium"):
        card = build_synthesizer(scene, None, segs, 16000)
        cpu = build_synthesizer(scene, None, segs, 16000, device="cpu")
        draws = card.scene_batched(gen, REVERB_BATCH)
        head, active, sectors, speakers, seg_idx, qoff = draws
        got = card.mix(head, active, speakers, seg_idx, qoff).cpu()
        cd = [d.cpu() for d in draws]
        want = cpu.mix(cd[0], cd[1], cd[3], cd[4], cd[5])
        same = torch.equal(card.labels_batched(head, active, sectors,
                                               speakers).cpu(),
                           cpu.labels_batched(cd[0], cd[1], cd[2], cd[3]))
        err = float((got - want).abs().max())
        LAUNCHES.clear()
        batch = card.sample_batch(gen, REVERB_BATCH)
        torch.cuda.synchronize()
        launches[f"{scene}_batch"] = dict(LAUNCHES)
        ms = cuda_ms(lambda: card.sample_batch(gen, REVERB_BATCH), reps=3,
                     inner=3)
        H = card.bank["H"]
        log(f"{scene} B={REVERB_BATCH}: {card.n_speakers} speakers, "
            f"{card.n_measurements} heads, BRIR spectra {tuple(H.shape)} "
            f"{H.dtype} {H.numel() * H.element_size() / 1e6!r} MB; max "
            f"|card - CPU| waveform {err!r} (atol {WAVE_ATOL}), labels equal: "
            f"{same}; launches per batch {launches[f'{scene}_batch']}; "
            f"{ms!r} ms per batch")
        got_l = launches[f"{scene}_batch"]
        if not (err <= WAVE_ATOL and same and got_l.get("cc_lags", 0) == 1
                and not got_l.get("gather_windows", 0)
                and not got_l.get("gather_mix_kb", 0)
                and all(bool(torch.isfinite(b).all()) for b in batch)):
            raise RuntimeError(f"{scene} batch: card and CPU disagree or "
                               "wrong kernels")
        if scene == "spirit":
            spirit = card

    # (b) the runner on conf/config_spirit.yaml as written
    launches["spirit_runner"], _, _ = runner_phase(
        torch, "config_spirit.yaml", 1, "spirit runner")

    # (c) a flagship chunk on the general anechoic path: a 1.2 s pool
    ir, az, dist = make_test_hrir_bank()
    general = AnechoicSynthesizer(ir, az, dist,
                                  make_test_segments(64, seg_len=19200))
    if general.fast or general.n_q != 26:
        raise RuntimeError("the 1.2 s pool did not take the general path")
    hp = TrainHyper()
    model = build_active(BiEARConfig(**GEOMETRY["dual"],
                                     fb_w_dtype="bfloat16"), seed=0)
    chunk = make_train_chunk(model, hp, make_optimizer(model, hp),
                             general.batch_fn(REVERB_BATCH), RUNNER_CHUNK)
    LAUNCHES.clear()
    ms = chunk(gen)
    torch.cuda.synchronize()
    launches["general_train"] = got_l = dict(LAUNCHES)
    losses = ms["loss"].tolist()
    rate = rate_windows(lambda: chunk(gen), REVERB_BATCH * RUNNER_CHUNK, 2)
    log(f"general path flagship chunk ({RUNNER_CHUNK} steps, B="
        f"{REVERB_BATCH}, bf16 filterbank, pool of 19,200-sample segments, "
        f"26 offsets): launches {launches['general_train']}; losses "
        f"{losses!r}, skipped {ms['skipped'].tolist()}; "
        f"{rate['median']!r} utterances/s [{rate['min']!r}-{rate['max']!r}]")
    if (got_l.get("cc_lags", 0) != RUNNER_CHUNK + WARMUP_STEPS
            or got_l.get("gather_mix_kb", 0)
            or got_l.get("gather_windows", 0)
            or not all(np.isfinite(losses))
            or float(ms["skipped"].sum()) != 0):
        raise RuntimeError("general path chunk: wrong kernels, nonfinite "
                           "loss or skipped step")

    # (d) the protocol's spirit checkpoint on a spirit shard
    with tempfile.TemporaryDirectory() as tmp:
        LAUNCHES.clear()
        launches["spirit_evaluate"] = protocol_shard_evaluation(
            torch, spirit, "spirit", tmp)
    return launches


def auralnet_step_card_vs_cpu(torch, hp, cfg, batch):
    """One f32 AuralNet step (dropout 0) on the card against the CPU port,
    stage by stage: the log features entering the three attention blocks,
    the loss, and every gradient with the CPU's blocks fed the card's
    features (BACKEND_RTOL in relative L2); the whole gradient is logged.
    Raises on disagreement."""
    from biear_tpu_torch.device import precision_highest
    from biear_tpu_torch.models import build_auralnet
    from biear_tpu_torch.train.loop import active_loss

    def step(model, b, feats=None):
        held = []
        blocks = (model.attn_L, model.attn_R, model.attn_diff)

        def take(i):
            def hook(m, args):
                if feats is None:
                    held.append(args[0].detach())
                    return None
                return (feats[i].to(args[0].device),) + args[1:]
            return hook
        hooks = [blk.register_forward_pre_hook(take(i))
                 for i, blk in enumerate(blocks)]
        model.train()
        names, params = zip(*model.named_parameters())
        with precision_highest():
            loss, _ = active_loss(model, hp, b, torch.Generator(
                device=b[0].device))
            grads = torch.autograd.grad(loss, params)
        for h in hooks:
            h.remove()
        return float(loss.detach()), dict(zip(names, grads)), held

    cb = tuple(t.cpu() for t in batch)
    gpu = build_auralnet(cfg, seed=3)
    cpu = build_auralnet(cfg, seed=3, device="cpu")
    lg, gg, fg = step(gpu, batch)
    lc, gc, fc = step(cpu, cb)
    d_feat = max(float((a.cpu() - b).abs().max()) for a, b in zip(fg, fc))
    _, gb, _ = step(cpu, cb, [f.cpu() for f in fg])
    d_grad = rel_l2(torch, gg, gb)
    whole = rel_l2(torch, gg, gc)
    dl = abs(lg - lc)
    log(f"auralnet B={batch[0].shape[0]} f32 step, card vs CPU: log features"
        f" max |d| {d_feat!r} (atol {AURALNET_FEAT_ATOL}); loss {lg!r} vs "
        f"{lc!r} (|d| {dl!r}, atol {STEP_LOSS_ATOL}); gradients with the "
        f"CPU's blocks on the card's features {d_grad!r} (limit "
        f"{BACKEND_RTOL}); whole gradients (not compared) {whole!r}")
    if not (d_feat <= AURALNET_FEAT_ATOL and dl <= STEP_LOSS_ATOL
            and d_grad <= BACKEND_RTOL):
        raise RuntimeError("auralnet train step: card and CPU disagree")


def phase_auralnet(torch, rng, synth):
    """Phase 13: AuralNet at conf/config_auralnet_deepear.yaml's width:
    serving, a fused chunk at TRAIN_BATCH (bf16), an f32 step and the
    card against the CPU, the runner on the config, the run's best
    checkpoint evaluated card vs CPU, and the streaming refusal."""
    import tempfile
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.models import BiEARConfig, build_auralnet
    from biear_tpu_torch.serve.profile_serve import AURALNET
    from biear_tpu_torch.serve.streaming import stream_init
    from biear_tpu_torch.graph import WARMUP_STEPS
    from biear_tpu_torch.train.loop import make_train_chunk, make_train_step
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer
    from biear_tpu_torch.train.profile_train import fixed_batch, rate_windows

    # (a) serving
    launches = {"auralnet_serve": phase_serve(torch, rng, "auralnet")}

    # (b) the fused chunk at TRAIN_BATCH, bf16
    hp = TrainHyper()
    cfg = BiEARConfig(**AURALNET, fb_w_dtype="bfloat16")
    model = build_auralnet(cfg, seed=0)
    opt = make_optimizer(model, hp)
    chunk = make_train_chunk(model, hp, opt, synth.batch_fn(TRAIN_BATCH),
                             TRAIN_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = snapshot(model)
    LAUNCHES.clear()
    ms = chunk(gen)
    torch.cuda.synchronize()
    launches["auralnet_train_bf16"] = got = dict(LAUNCHES)
    losses = ms["loss"].tolist()
    moved = {n: float((p - before[n]).abs().max())
             for n, p in snapshot(model).items()}
    parts = {k: max(v for n, v in moved.items() if n.startswith(k + "."))
             for k in ("attn_L", "attn_R", "attn_diff", "cc_proj", "body",
                       "subheads")}
    log(f"auralnet train chunk ({TRAIN_STEPS} steps, B={TRAIN_BATCH}, bf16)"
        f" launches: {got}; losses {losses!r}, skipped "
        f"{ms['skipped'].tolist()}; backend grad norms "
        f"{ms['grad_backend_norm'].tolist()!r}; max parameter change by "
        f"part {parts!r}")
    if (got.get("gather_mix_kb", 0) != TRAIN_STEPS + WARMUP_STEPS
            or got.get("cc_lags", 0) != TRAIN_STEPS + WARMUP_STEPS
            or got.get("gather_windows", 0)
            or not all(np.isfinite(losses))
            or float(ms["skipped"].sum()) != 0
            or not min(parts.values()) > 0):
        raise RuntimeError("auralnet train chunk: wrong kernels, nonfinite "
                           "loss, skipped step or a part that did not move")
    fused = rate_windows(lambda: chunk(gen), TRAIN_BATCH * TRAIN_STEPS, 3)
    fb = fixed_batch(TRAIN_BATCH, cfg.n_bands, 0, "cuda")
    step = make_train_step(model, hp, opt)
    step(fb, gen)
    bare = rate_windows(lambda: [step(fb, gen) for _ in range(TRAIN_STEPS)],
                        TRAIN_BATCH * TRAIN_STEPS, 3)
    log(f"auralnet train B={TRAIN_BATCH} bf16: fused pipeline "
        f"{fused['median']!r} utterances/s [{fused['min']!r}-"
        f"{fused['max']!r}], bare step {bare['median']!r} utterances/s "
        f"[{bare['min']!r}-{bare['max']!r}] (windows of {TRAIN_STEPS} steps)")

    # an f32 step at batch 64 (the window gather), then the card against
    # the CPU port on a synthesised batch of 64 with dropout 0
    cfg32 = BiEARConfig(**AURALNET, fb_w_dtype="float32")
    m32 = build_auralnet(cfg32, seed=0)
    synth32 = training_synth(torch, "float32")
    chunk32 = make_train_chunk(m32, hp, make_optimizer(m32, hp),
                               synth32.batch_fn(64), 1)
    LAUNCHES.clear()
    ms32 = chunk32(gen)
    torch.cuda.synchronize()
    launches["auralnet_train_f32"] = got = dict(LAUNCHES)
    log(f"auralnet train step (B=64, f32) launches: {got}, loss "
        f"{float(ms32['loss'][0])!r}")
    if (got.get("gather_windows", 0) != 1 + WARMUP_STEPS
            or got.get("cc_lags", 0) != 1 + WARMUP_STEPS
            or got.get("gather_mix_kb", 0)
            or not bool(torch.isfinite(ms32["loss"]).all())
            or float(ms32["skipped"].sum()) != 0):
        raise RuntimeError("auralnet f32 train step: wrong kernels or bad "
                           "loss")
    cfg0 = BiEARConfig(**AURALNET, fb_w_dtype="float32", attn_dropout=0.0,
                       backend_dropout=0.0)
    auralnet_step_card_vs_cpu(torch, hp, cfg0, synth32.sample_batch(gen, 64))

    with tempfile.TemporaryDirectory() as tmp:
        # (c) the runner on the AuralNet config, synthesised (f32 mix)
        launches["auralnet_runner"], rc, rsynth = runner_phase(
            torch, "config_auralnet_deepear.yaml", 2, "auralnet runner",
            runs_root=tmp)
        (run,) = os.listdir(tmp)
        run = os.path.join(tmp, run)
        if os.listdir(os.path.join(run, "q_vis")):
            raise RuntimeError("auralnet runner: Q plots written")
        # (d) its best checkpoint on a shard synthesised on the card
        from biear_tpu_torch.data.shard import write_shard
        with open(os.path.join(run, "meta", "settings.json")) as f:
            settings = json.load(f)
        LAUNCHES.clear()
        batch = rsynth.sample_batch(torch.Generator(device="cuda")
                                    .manual_seed(9), EVAL_ROWS)
        torch.cuda.synchronize()
        shard_launches = dict(LAUNCHES)
        shard = os.path.join(tmp, "test.shard")
        write_shard(shard, [a.cpu().numpy() for a in batch],
                    ["i16", "i16", "f32", "f32"])
        ev = compare_evaluations(
            torch, "evaluate auralnet",
            os.path.join(run, "checkpoints", "best", "params.pth"), settings,
            shard, tmp, SERVE_TOL[rc.model_cfg.fb_w_dtype], witness=False)
        for k, v in shard_launches.items():
            ev[k] = ev.get(k, 0) + v
        launches["auralnet_evaluate"] = ev

    # (e) AuralNet does not stream
    try:
        stream_init(model, 2)
    except NotImplementedError as e:
        log(f"auralnet stream_init refused: {e}")
    else:
        raise RuntimeError("stream_init accepted AuralNet")
    return launches


def protocol_common() -> list:
    """The flags phase 14's driver runs share with its post-hoc tools."""
    pool, _, eval_size = PROTOCOL_SIZES
    return ["--corpus", "speech", "--noise-snr", "5,25", "--pool-size",
            str(pool), "--eval-size", str(eval_size), "--quiet"]


def phase_protocol(torch, tmp: str):
    """Phase 14: ``run_full_protocol`` on the card at full width and a
    small scale (speech corpus, noise at 5-25 dB, PROTOCOL_SIZES) for
    AuralNet and for conf/config.yaml --fixed-q; ``protocol_eval`` on the
    AuralNet run reproducing its test1 / test2 files byte for byte;
    ``eval_by_snr`` over both runs at 5 and 25 dB and clean. One CC and
    one window-gather launch per batch, no mix. The runs stay under `tmp`
    for phase 15; returns (launches, {label: run directory})."""
    from biear_tpu_torch import eval_by_snr, protocol_eval, run_full_protocol
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.graph import WARMUP_STEPS

    here = os.path.dirname(os.path.abspath(__file__))
    pool, train_size, eval_size = PROTOCOL_SIZES
    common = protocol_common()
    launches, runs = {}, {}
    for label, conf, extra in (
            ("auralnet", "config_auralnet_deepear.yaml", []),
            ("fixedq", "config.yaml", ["--fixed-q"])):
        argv = (["--config", os.path.join(here, "conf", conf),
                 "--train-size", str(train_size), "--epochs", "1",
                 "--runs-root", tmp, "--comments", f"smoke-{label}"]
                + common + extra)
        LAUNCHES.clear()
        t0 = time.perf_counter()
        res = run_full_protocol.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[f"protocol_{label}"] = got = dict(LAUNCHES)
        val_b, test_b = synth_eval_batches(eval_size, 64)
        steps = train_size // 64
        # training steps (the chunk's capture: WARMUP_STEPS more), the
        # sanity batch, the runner's val and test splits, then test1 and
        # test2
        want = steps + WARMUP_STEPS + 1 + val_b + 3 * test_b
        tr = res["history"]["train"][0]
        log(f"protocol {label}: launches {got} (expected {want} of "
            f"cc_lags and gather_windows); pools {res['pool_s']!r} s, "
            f"train {steps * 64 / tr['sec']!r} utt/s, test splits ms "
            f"{res['test_ms']!r}, wall {wall!r} s; test1 "
            f"{json.dumps(res['test1']['overall'])}")
        for name in ("test1", "test2"):
            path = os.path.join(res["run_dir"],
                                f"evaluate_biear_metrics_{name}.json")
            with open(path) as f:
                if set(json.load(f)) != {"overall", "1spk", "2spk",
                                         "3spk"}:
                    raise RuntimeError(f"protocol {label}: {name} JSON")
        if (got.get("cc_lags", 0) != want
                or got.get("gather_windows", 0) != want
                or got.get("gather_mix_kb", 0)
                or not np.isfinite(tr["loss"]) or tr["skipped"]):
            raise RuntimeError(f"protocol {label}: wrong launches or "
                               f"bad training {tr}")
        runs[label] = res["run_dir"]

    run = runs["auralnet"]
    files = {n: os.path.join(run, f"evaluate_biear_metrics_{n}.json")
             for n in ("test1", "test2")}
    before = {n: open(p, "rb").read() for n, p in files.items()}
    for p in files.values():
        os.remove(p)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    protocol_eval.main([run, "--device", "cuda"] + common)
    torch.cuda.synchronize()
    launches["protocol_eval"] = got = dict(LAUNCHES)
    same = all(open(p, "rb").read() == before[n]
               for n, p in files.items())
    log(f"protocol_eval on the auralnet run: test1 / test2 reproduced "
        f"byte for byte: {same}; launches {got}; "
        f"{time.perf_counter() - t0!r} s")
    if not same or got.get("cc_lags", 0) != 2 * test_b:
        raise RuntimeError("protocol_eval differs from run_full_protocol")

    LAUNCHES.clear()
    t0 = time.perf_counter()
    out = os.path.join(tmp, "snr.json")
    res = eval_by_snr.main([runs["auralnet"], runs["fixedq"], "--snrs",
                            "5,25", "--eval-size", str(eval_size),
                            "--pool-size", str(pool), "--out", out,
                            "--quiet"])
    torch.cuda.synchronize()
    launches["eval_by_snr"] = got = dict(LAUNCHES)
    log(f"eval_by_snr (2 runs, 5 dB, 25 dB, clean): launches {got}; "
        f"{time.perf_counter() - t0!r} s; "
        f"{json.dumps(res['runs'])}")
    if (not os.path.exists(out) or got.get("cc_lags", 0) != 3 * test_b
            or any(set(v) != {"5dB", "25dB", "clean"}
                   for v in res["runs"].values())):
        raise RuntimeError("eval_by_snr: wrong slices or launches")
    return launches, runs

def wrapped_phase_err(a, b):
    """Largest |a - b| wrapped to (-pi, pi], float64."""
    d = np.angle(np.exp(1j * (a.astype(np.float64) - b)))
    return float(np.abs(d).max()) if d.size else 0.0


def tree_mb(path: str) -> float:
    """Megabytes of the files under `path` (or of the file)."""
    if os.path.isfile(path):
        return os.path.getsize(path) / 1e6
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs) / 1e6


def timed_launches(torch, fn):
    """fn() with the launch counts zeroed just before and read just after
    (synchronised): (result, launches, host seconds)."""
    from biear_tpu_torch.kernels import LAUNCHES
    LAUNCHES.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(LAUNCHES), time.perf_counter() - t0


def check_launches(label: str, got: dict, want: dict) -> None:
    """Every kernel's count equals want's (0 where want does not name it)."""
    for k in ("cc_lags", "gather_windows", "gather_mix_kb"):
        if got.get(k, 0) != want.get(k, 0):
            raise RuntimeError(f"{label}: {k} launched {got.get(k, 0)} "
                               f"times, not {want.get(k, 0)}")


def dataset_write(torch, work: str) -> tuple:
    """Phase 15 (a): the anechoic test-thirds split and the spirit split,
    written on the card. Returns (launches, the anechoic split's
    directory, rows per second)."""
    from biear_tpu_torch import generate_binaural_data as gen
    from biear_tpu_torch.data.labels import build_label_from_npz_dict

    root = os.path.join(work, "splits")
    n = DATASET_ROWS
    y, got, sec = timed_launches(torch, lambda: gen.main(
        ["--out-root", root, "--name", "anechoic_test1", "--num", str(n),
         "--seed", "11", "--test-thirds"]))
    split = os.path.join(root, "anechoic_test1")
    batches = -(-n // 3 // 256) * 3
    check_launches("write_split", got, {"cc_lags": batches,
                                        "gather_windows": batches})
    names = sorted(os.listdir(split))
    if len(names) != 2 * n:
        raise RuntimeError(f"write_split: {len(names)} files, not {2 * n}")
    counts = []
    for i in range(n):
        d = np.load(os.path.join(split, f"anechoic_test1_{i:06d}.npz"))
        counts.append(int(d["num_sources"]))
        if not np.array_equal(build_label_from_npz_dict(d), y[i]):
            raise RuntimeError(f"write_split: npz {i} does not rebuild the "
                               "batch's label")
    third = n // 3
    want = [1] * third + [2] * third + [3] * (n - 2 * third)
    if counts != want:
        raise RuntimeError("write_split: wrong source counts per third")
    rate = n / sec
    log(f"dataset (a) write_split anechoic {n} rows, test thirds: "
        f"launches {got}; {sec!r} s ({rate!r} rows/s), "
        f"{tree_mb(split)!r} MB; source counts 1/2/3 per third, every npz "
        "label equal to its batch's y")

    _, sgot, ssec = timed_launches(torch, lambda: gen.main(
        ["--out-root", root, "--scene", "spirit", "--name", "spirit_val",
         "--num", str(SPIRIT_ROWS), "--seed", "12"]))
    check_launches("write_split spirit", sgot, {"cc_lags": 1})
    nfiles = len(os.listdir(os.path.join(root, "spirit_val")))
    if nfiles != 2 * SPIRIT_ROWS:
        raise RuntimeError(f"spirit split: {nfiles} files")
    log(f"dataset (a) write_split spirit {SPIRIT_ROWS} rows (rFFT mix): "
        f"launches {sgot}; {ssec!r} s ({SPIRIT_ROWS / ssec!r} rows/s)")
    return {"dataset_write": got, "dataset_write_spirit": sgot}, split, rate


def dataset_precompute(torch, split: str, shards: str, tmp: str) -> tuple:
    """Phase 15 (b) and (c): precompute_h5 --from-dir on the split (the
    val and test shards), card against the CPU port on its first
    COMPARE_ROWS rows; precompute_h5 --synth SYNTH_ROWS (the train
    shards). Returns (launches, metrics)."""
    import shutil
    from biear_tpu_torch import precompute_h5 as pre

    n = DATASET_ROWS
    act = os.path.join(shards, "anechoic_val_active_wav.shard")
    pas = os.path.join(shards, "anechoic_val_gt_group_phase.shard")
    card, got, sec = timed_launches(torch, lambda: pre.main(
        ["--from-dir", split, "--out-active", act, "--out-passive", pas]))
    per512 = -(-n // 512)
    check_launches("precompute --from-dir", got, {"cc_lags": 2 * per512})
    shutil.copyfile(act, os.path.join(shards,
                                      "anechoic_test1_active_wav.shard"))
    shutil.copyfile(pas, os.path.join(shards,
                                      "anechoic_test2_gt_group_phase.shard"))
    cpu = pre.main(["--from-dir", split, "--max-samples", str(COMPARE_ROWS),
                    "--out-active", os.path.join(tmp, "a.shard"),
                    "--out-passive", os.path.join(tmp, "p.shard"),
                    "--device", "cpu"])
    m = COMPARE_ROWS
    a, c = card["active"], cpu["active"]
    same = all(np.array_equal(a[i][:m], c[i]) for i in (0, 1, 3))
    e_cc = float(np.abs(a[2][:m] - c[2]).max())
    cc_ok = np.allclose(a[2][:m], c[2], rtol=CC_RTOL, atol=CC_ATOL)
    pa, pc = card["passive"], cpu["passive"]
    strong = [pc[i] > -60.0 for i in (0, 1)]
    e_mag = max(float(np.abs(pa[i][:m] - pc[i])[strong[i]].max())
                for i in (0, 1))
    e_ph = max(wrapped_phase_err(pa[i][:m][strong[j]], pc[i][strong[j]])
               for i, j in ((3, 0), (4, 1)))
    p_same = np.array_equal(pa[5][:m], pc[5])
    p_cc = np.allclose(pa[2][:m], pc[2], rtol=CC_RTOL, atol=CC_ATOL)
    log(f"dataset (b) precompute --from-dir {n} rows -> active and passive "
        f".shard: launches {got}; {sec!r} s with the wav reads "
        f"({n / sec!r} rows/s), {tree_mb(act)!r} + {tree_mb(pas)!r} MB; card "
        f"vs CPU on {m} rows: x1, x2, y equal {same}, CC max |d| {e_cc!r} "
        f"(rtol {CC_RTOL}, atol {CC_ATOL}: {cc_ok}); passive magnitude "
        f"{e_mag!r} dB (limit {FEATURE_DB_TOL!r}), wrapped phase {e_ph!r} "
        f"rad (limit {FEATURE_RAD_TOL}), CC {p_cc}, y equal {p_same}")
    if not (same and cc_ok and p_same and p_cc and e_mag <= FEATURE_DB_TOL
            and e_ph <= FEATURE_RAD_TOL):
        raise RuntimeError("precompute: card and CPU disagree")
    wl, wr, y = a[0], a[1], a[3]
    ms = {}
    for name, fn in (("active", pre.build_active),
                     ("passive", pre.build_passive)):
        out = os.path.join(tmp, f"t.{name}.shard")
        fn(wl, wr, y, 16000, out)
        t0 = time.perf_counter()
        fn(wl, wr, y, 16000, out)
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0) * 512 / n

    train_act = os.path.join(shards, "anechoic_train_active_wav.shard")
    train_pas = os.path.join(shards, "anechoic_train_gt_group_phase.shard")
    N = SYNTH_ROWS
    _, sgot, ssec = timed_launches(torch, lambda: pre.main(
        ["--synth", str(N), "--seed", "5", "--out-active", train_act,
         "--out-passive", train_pas]))
    nb, n512 = -(-N // 256), -(-N // 512)
    check_launches("precompute --synth", sgot,
                   {"cc_lags": nb + 2 * n512, "gather_windows": nb})
    mb = (tree_mb(train_act), tree_mb(train_pas))
    log(f"dataset (c) precompute --synth {N} -> active and passive .shard: "
        f"launches {sgot}; {ssec!r} s ({N / ssec!r} rows/s), "
        f"{mb[0]!r} + {mb[1]!r} MB; builders alone on {n} rows: "
        f"build_active {ms['active']!r} ms, build_passive "
        f"{ms['passive']!r} ms per 512 rows (with the .shard writes)")
    metrics = {"precompute_dir_rows_s": n / sec,
               "precompute_synth_rows_s": N / ssec,
               "ms_per_512": ms, "train_shard_mb": mb}
    return ({"dataset_precompute_dir": got,
             "dataset_precompute_synth": sgot}, metrics)


def dataset_runner(torch, shards: str, work: str, tmp: str,
                   runner_metrics: dict) -> dict:
    """Phase 15 (d): the runner on conf/config.yaml and on
    conf/config_passive.yaml, one epoch each from the shards (no kernel:
    the CC is in the files); evaluate of the active run's best on the
    test shard, card against CPU as in phase 9. Returns launches."""
    from biear_tpu_torch.config import load_run_config
    from biear_tpu_torch.train.runner import train

    here = os.path.dirname(os.path.abspath(__file__))
    launches, runs = {}, {}
    for name, label in (("config.yaml", "dataset_runner"),
                        ("config_passive.yaml", "dataset_runner_passive")):
        rc = load_run_config(os.path.join(here, "conf", name))
        rc.data_format, rc.shard_root = "shard", shards
        rc.epochs, rc.runs_root = 1, os.path.join(work, "runs")
        torch.cuda.reset_peak_memory_stats()
        out, got, wall = timed_launches(torch, lambda: train(
            rc, run_id=label, quiet=True))
        launches[label] = got
        check_launches(label, got, {})
        hist = check_run_tree(out["run_dir"], label)
        steps = -(-SYNTH_ROWS // rc.batch_size)
        tr, va = hist["train"][0], hist["val"][0]
        if (out["global_step"] != steps or tr["skipped"]
                or not np.isfinite([tr["loss"], va["loss"],
                                    out["test"]["loss"]]).all()):
            raise RuntimeError(f"{label}: history {hist}")
        runs[label] = out["run_dir"]
        log(f"dataset (d) runner on conf/{name} from .shard files: "
            f"{SYNTH_ROWS} train rows ({steps} steps of {rc.batch_size}), "
            f"val and test {DATASET_ROWS}: s per epoch (train + val) "
            f"{tr['sec'] + va['sec']!r}, train utt/s "
            f"{SYNTH_ROWS / tr['sec']!r}, peak memory "
            f"{torch.cuda.max_memory_allocated()!r} B, wall {wall!r} s; "
            f"launches {got}; losses train {tr['loss']!r} val "
            f"{va['loss']!r} test {out['test']['loss']!r}")
    log(f"dataset (d) beside phase 10 (synthesised, {RUNNER_STEPS} steps per "
        f"epoch): s per epoch {runner_metrics['epoch_s']!r}, train utt/s "
        f"{runner_metrics['runner_train_utt_s']!r}")

    run = runs["dataset_runner"]
    with open(os.path.join(run, "meta", "settings.json")) as f:
        settings = json.load(f)
    launches["dataset_evaluate"] = compare_evaluations(
        torch, "dataset evaluate",
        os.path.join(run, "checkpoints", "best", "params.pth"), settings,
        os.path.join(shards, "anechoic_test1_active_wav.shard"), tmp,
        SERVE_TOL["float32"], witness=False)
    return launches


def dataset_stream_demo(torch, tmp: str) -> dict:
    """Phase 15 (e): stream_demo on docs/protocol_r3/flagship-s1 (n_src 2,
    seed 4); its per-hop beliefs card against CPU on the card's scene, to
    STREAM_ATOL or, where the trained checkpoint needs it, to the CPU's
    own change under 1e-6 relative waveform noise. Returns launches."""
    from biear_tpu_torch import stream_demo
    from biear_tpu_torch.config import config_from_settings
    from biear_tpu_torch.serve.infer import load_model

    here = os.path.dirname(os.path.abspath(__file__))
    archive = os.path.join(here, "docs", "protocol_r3", "flagship-s1")
    js = os.path.join(tmp, "stream_demo.json")
    out, got, sec = timed_launches(torch, lambda: stream_demo.main(
        ["--archive", archive, "--n-src", "2", "--seed", "4", "--json", js,
         "--png", os.path.join(tmp, "stream_demo.png")]))
    check_launches("stream_demo", got, {"cc_lags": 1, "gather_windows": 1})
    with open(os.path.join(archive, "settings.json")) as f:
        cfg = config_from_settings(json.load(f))
    pth = os.path.join(archive, "best.pth")
    card_model, cpu_model = (load_model(pth, cfg, d) for d in ("cuda", "cpu"))
    wavL, wavR, gt = stream_demo.demo_scene(cfg, 2, 4, device="cuda")
    p_card = stream_demo.stream_beliefs(card_model, wavL, wavR)
    t0 = time.perf_counter()
    for _ in range(3):
        stream_demo.stream_beliefs(card_model, wavL, wavR)
    torch.cuda.synchronize()
    hop_ms = 1e3 * (time.perf_counter() - t0) / (3 * cfg.timesteps)
    wl, wr = wavL.cpu().numpy(), wavR.cpu().numpy()
    p_cpu = stream_demo.stream_beliefs(cpu_model, wl, wr)
    noise = np.random.default_rng(5).standard_normal((2,) + wl.shape)
    p_wit = stream_demo.stream_beliefs(
        cpu_model, (wl * (1 + 1e-6 * noise[0])).astype(np.float32),
        (wr * (1 + 1e-6 * noise[1])).astype(np.float32))
    err = float(np.abs(p_card - p_cpu).max())
    spread = float(np.abs(p_wit - p_cpu).max())
    tol = max(STREAM_ATOL, spread)
    same_json = (gt == out["gt_sectors"] and out["probs_per_hop"]
                 == [[round(float(v), 4) for v in p] for p in p_card])
    log(f"dataset (e) stream_demo flagship-s1, n_src 2, seed 4: launches "
        f"{got}; {sec!r} s in all, {hop_ms!r} ms per hop on the card "
        f"(stream_step and readout, batch 1); true sectors "
        f"{out['gt_sectors']}, decision {out['pred_sectors']}, settled at "
        f"hop {out['settled_at_hop']} ({out['settled_at_s']} s); per-hop "
        f"beliefs card vs CPU max |d| {err!r}, CPU's own spread under 1e-6 "
        f"noise {spread!r}: limit {tol!r} "
        f"({'STREAM_ATOL' if tol == STREAM_ATOL else 'the witness'}); JSON "
        f"from the same scene: {same_json}")
    if not (err <= tol and same_json and len(out["probs_per_hop"])
            == cfg.timesteps):
        raise RuntimeError("stream_demo: card and CPU disagree")
    return {"stream_demo": got}


def dataset_archive(torch, run: str, tmp: str) -> dict:
    """Phase 15 (f): archive_protocol_run on phase 14's AuralNet run; the
    exported best.pth loads strictly into a fresh port AuralNet and,
    scored by protocol_eval on phase 14's test splits, writes the run's
    test1 / test2 files byte for byte. Returns launches."""
    import shutil
    from biear_tpu_torch import archive_protocol_run, protocol_eval
    from biear_tpu_torch.config import config_from_settings
    from biear_tpu_torch.models import AuralNet

    out = archive_protocol_run.main([run, "auralnet-smoke", "--dest", tmp])
    copied = all(open(os.path.join(out, os.path.basename(rel)), "rb").read()
                 == open(os.path.join(run, rel), "rb").read()
                 for rel in ("evaluate_biear_metrics_test1.json",
                             "evaluate_biear_metrics_test2.json",
                             "logs_json/test_metrics.json",
                             "meta/settings.json"))
    with open(os.path.join(out, "settings.json")) as f:
        settings = json.load(f)
    sd = torch.load(os.path.join(out, "best.pth"), weights_only=True)
    AuralNet(config_from_settings(settings)).load_state_dict(sd, strict=True)
    rd = os.path.join(tmp, "archived-run")
    os.makedirs(os.path.join(rd, "checkpoints", "best"))
    os.makedirs(os.path.join(rd, "meta"))
    shutil.copyfile(os.path.join(out, "best.pth"),
                    os.path.join(rd, "checkpoints", "best", "params.pth"))
    shutil.copyfile(os.path.join(out, "settings.json"),
                    os.path.join(rd, "meta", "settings.json"))
    _, got, sec = timed_launches(torch, lambda: protocol_eval.main(
        [rd, "--device", "cuda"] + protocol_common()))
    test_b = synth_eval_batches(PROTOCOL_SIZES[2], 64)[1]
    check_launches("archive scoring", got, {"cc_lags": 2 * test_b,
                                            "gather_windows": 2 * test_b})
    same = all(
        open(os.path.join(rd, f"evaluate_biear_metrics_{n}.json"),
             "rb").read()
        == open(os.path.join(run, f"evaluate_biear_metrics_{n}.json"),
                "rb").read() for n in ("test1", "test2"))
    log(f"dataset (f) archive_protocol_run of the AuralNet run: metric files "
        f"byte-copied {copied}; best.pth ({len(sd)} tensors, attention "
        f"included: {any('self_attn' in k for k in sd)}) loads strictly; "
        f"scored on phase 14's splits, test1 / test2 byte for byte: {same}; "
        f"launches {got}; {sec!r} s")
    if not (copied and same):
        raise RuntimeError("archive_protocol_run: the archive differs from "
                           "the run")
    return {"archive_scoring": got}


def phase_dataset(torch, work: str, auralnet_run: str,
                  runner_metrics: dict) -> dict:
    """Phase 15: the offline dataset path at full width (a-d), the
    streaming demo (e) and the run archiver (f)."""
    import tempfile

    shards = os.path.join(work, "shards")
    os.makedirs(shards)
    with tempfile.TemporaryDirectory() as tmp:
        launches, split, _ = dataset_write(torch, work)
        got, _ = dataset_precompute(torch, split, shards, tmp)
        launches.update(got)
        launches.update(dataset_runner(torch, shards, work, tmp,
                                       runner_metrics))
        launches.update(dataset_stream_demo(torch, tmp))
        launches.update(dataset_archive(torch, auralnet_run, tmp))
    return launches


def dist_run_config(runs_root: str, mesh: tuple):
    """conf/config.yaml as phase 10 runs it, for one epoch, with dropout 0,
    a loss in scalars.jsonl at every step, over the mesh (data, model)."""
    import dataclasses
    rc = synthesised_run_config("config.yaml", 1)
    rc.model_cfg = dataclasses.replace(rc.model_cfg, ctrl_dropout=0.0,
                                       backend_dropout=0.0)
    rc.hist_every, rc.runs_root = 1, runs_root
    rc.mesh_data, rc.mesh_model = mesh
    return rc


def step_scalars(run: str) -> dict:
    """The per-step train loss and gradient norms a run logged, each in
    step order."""
    with open(os.path.join(run, "logs_json", "scalars.jsonl")) as f:
        recs = sorted((r for r in map(json.loads, f)
                       if "train_step/loss" in r), key=lambda r: r["step"])
    return {k: [r[f"train_step/{k}"] for r in recs] for k in DIST_SCALARS}


def max_rel(got: list, want: list) -> float:
    """max |got - want| / |want| over a run's steps (0 where both are 0)."""
    return max(abs(g - w) / abs(w) if w else abs(g)
               for g, w in zip(got, want))


def allreduce_ms(torch, n: int, device) -> dict:
    """The flat all-reduce of n float32 values over the world: ms per call
    by CUDA events around ALLREDUCE_REPS calls, and by the host clock."""
    import torch.distributed as dist
    buf = torch.ones(n, device=device)
    dist.all_reduce(buf)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(ALLREDUCE_REPS):
        dist.all_reduce(buf)
    end.record()
    torch.cuda.synchronize()
    return {"floats": n,
            "event_ms": start.elapsed_time(end) / ALLREDUCE_REPS,
            "host_ms": (time.perf_counter() - t0) * 1e3 / ALLREDUCE_REPS}


def dist_chunk(torch, device) -> dict:
    """Phase 16 (c) on one rank of two: the fused bf16 chunk of the
    flagship at DIST_RANK_BATCH rows per rank, this rank's rows of each
    global batch, over a 2x1 mesh, captured (two graphs a step around the
    gloo all-reduce) and with capture=False (twice, the witness pair) from
    one seeded state, DIST_CHUNKS chunks of DIST_CHUNK_STEPS steps, the
    generators and this rank's dropout streams re-seeded in place per
    chunk as the runner does. After every chunk the captured run's
    batches and generator states equal the eager run's bit for bit, its
    losses and parameters lie within CAPTURE_WITNESS times the eager pair's
    spread. The mix and CC kernels launch once per replay. Then each path
    is profiled over one chunk on rank 0 (rank 1 runs the same chunks
    untraced: their all-reduces pair up)."""
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.parallel.mesh import Mesh
    from biear_tpu_torch.serve.profile_serve import GEOMETRY, device_profile
    from biear_tpu_torch.train.graph import CapturedMeshChunk
    from biear_tpu_torch.train.loop import make_train_chunk
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer
    from biear_tpu_torch.train.runner import dropout_streams, keyed_seed

    mesh = Mesh(2, 1, device)
    hp = TrainHyper()
    B, steps = DIST_RANK_BATCH * mesh.data, DIST_CHUNK_STEPS
    cfg = BiEARConfig(**GEOMETRY["dual"], fb_w_dtype="bfloat16")
    synth_fn = training_synth(torch, "bfloat16").batch_fn(B,
                                                          rows=mesh.rows(B))
    runs = {}
    for name, capture in (("eager", False), ("witness", False),
                          ("captured", None)):
        model = build_active(cfg, seed=0, device=device)
        mesh.broadcast_module_(model)
        fn, bufs, row = recording_batch_fn(torch, synth_fn, steps)
        runs[name] = {"model": model, "bufs": bufs, "row": row, "rates": [],
                      "gen": torch.Generator(device=device), "drop": None,
                      "chunk": make_train_chunk(model, hp,
                                                make_optimizer(model, hp),
                                                fn, steps, mesh=mesh,
                                                capture=capture)}
    if not isinstance(runs["captured"]["chunk"], CapturedMeshChunk):
        raise RuntimeError("distributed (c): the default chunk under 2x1 is "
                           f"{type(runs['captured']['chunk'])}")

    def call(r, c):
        r["gen"].manual_seed(keyed_seed(0, 1, c))
        r["drop"] = dropout_streams(mesh, r["gen"], device, 0, 1, c,
                                    streams=r["drop"])
        r["row"].zero_()
        return r["chunk"](r["gen"], 1.0, r["drop"])

    gens = lambda r: [r["gen"]] + ([] if r["drop"] is None
                                   else r["drop"].generators())
    # capture before the first chunk, so that the warm-up's recorded
    # batches (its steps advance the recording row) are overwritten
    cap = runs["captured"]
    cap["gen"].manual_seed(keyed_seed(0, 1, 0))
    cap["drop"] = dropout_streams(mesh, cap["gen"], device, 0, 1, 0)
    cap["chunk"].capture(cap["gen"], cap["drop"])
    launches, worst = {}, {"loss": (0.0, 0.0), "params": (0.0, 0.0)}
    for c in range(DIST_CHUNKS):
        ms = {}
        for name, r in runs.items():
            torch.cuda.synchronize()
            LAUNCHES.clear()
            t0 = time.perf_counter()
            ms[name] = call(r, c)
            torch.cuda.synchronize()
            r["rates"].append(DIST_RANK_BATCH * steps
                              / (time.perf_counter() - t0))
            if c == DIST_CHUNKS - 1:
                launches[name] = dict(LAUNCHES)
        e = runs["eager"]
        for name in ("witness", "captured"):
            r = runs[name]
            if not (all(torch.equal(a, b) for a, b in zip(r["bufs"],
                                                          e["bufs"]))
                    and all(torch.equal(a.get_state(), b.get_state())
                            for a, b in zip(gens(r), gens(e)))):
                raise RuntimeError(f"distributed (c) chunk {c}: the {name} "
                                   "run's batches or generator states "
                                   "differ from the eager run's")
        for key, got, want, wit in (
                ("loss", {"l": ms["captured"]["loss"]},
                 {"l": ms["eager"]["loss"]}, {"l": ms["witness"]["loss"]}),
                ("params", snapshot(runs["captured"]["model"]),
                 snapshot(e["model"]), snapshot(runs["witness"]["model"]))):
            err, spread = max_abs(torch, got, want), max_abs(torch, wit, want)
            worst[key] = (max(worst[key][0], err), max(worst[key][1], spread))
            if err > CAPTURE_WITNESS * spread:
                raise RuntimeError(
                    f"distributed (c) chunk {c}: captured {key} off the "
                    f"eager run by {err!r}, {CAPTURE_WITNESS!r} x the "
                    f"witness spread {spread!r}")
        if not (bool(torch.isfinite(ms["captured"]["loss"]).all())
                and float(ms["captured"]["skipped"].sum()) == 0):
            raise RuntimeError(f"distributed (c) chunk {c}: nonfinite loss "
                               "or a skipped step")
    out = {"launches": launches["captured"],
           "eager_launches": launches["eager"],
           "losses": ms["captured"]["loss"].tolist(),
           "loss_err": worst["loss"], "param_err": worst["params"],
           "stats": runs["captured"]["chunk"].stats, "profile": {}}
    for name in ("captured", "eager"):
        r = runs[name]
        out[f"{name}_utt_s_per_rank"] = statistics.median(r["rates"][1:])
        if mesh.rank == 0:
            prof = device_profile(lambda: call(r, DIST_CHUNKS), calls=1)
            out["profile"][name] = {
                "step_wall_ms": prof["wall_ms_per_call"] / steps,
                "busy_ms_per_step": prof["device_busy_ms_per_call"] / steps,
                "idle_share": prof["device_idle_share"],
                "kernels_per_step": prof["kernels_per_call"] / steps,
                "host_launches_per_step":
                    prof["host_launches_per_call"] / steps}
        else:
            for _ in range(2):        # device_profile's warm and traced call
                call(r, DIST_CHUNKS)
            torch.cuda.synchronize()
    return out


def dist_worker(spec_path: str) -> int:
    """One rank of phase 16, started by torchrun: a probe of NCCL, or the
    spec's runner runs (and the bf16 chunk) under its backend; writes this
    rank's results as JSON into the spec's directory."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from biear_tpu_torch import train_biear
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.parallel.mesh import init_distributed
    from biear_tpu_torch.train.runner import train

    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    out = {"rank": rank}
    if spec["task"] == "nccl-probe":
        try:
            init_distributed(backend="nccl")
            t = torch.ones(1, device="cuda")
            dist.all_reduce(t)
            torch.cuda.synchronize()
            out["error"] = None
        except Exception as e:        # NCCL's refusal is the expected end
            out["error"] = f"{type(e).__name__}: {e}"
    else:
        device = init_distributed(backend=spec.get("backend"))
        out["backend"] = dist.get_backend()
        out["runs"] = {}
        for run in spec["runs"]:
            rc = dist_run_config(run["root"], tuple(run["mesh"]))
            synth = train_biear.make_synth(rc, device)
            LAUNCHES.clear()
            res = train(rc, synth=synth, run_id=run["name"], quiet=True,
                        device=device)
            torch.cuda.synchronize()
            n = sum(p.numel() for p in res["model"].parameters())
            data_parallel = rc.mesh_model == 1
            out["runs"][run["name"]] = {
                "launches": dict(LAUNCHES), "run_dir": res["run_dir"],
                "history": {k: [{m: v for m, v in e.items() if m != "sec"}
                                for e in h]
                            for k, h in res["history"].items()},
                "utt_s_per_rank": [RUNNER_STEPS * rc.batch_size / rc.mesh_data
                                   / e["sec"] for e in
                                   res["history"]["train"]],
                # the step's flat buffer (gradients, W, W loss, the three
                # metrics) over its data group, here the world
                "allreduce": (allreduce_ms(torch, n + 5, device)
                              if data_parallel else None)}
        if spec.get("chunk"):
            out["chunk"] = dist_chunk(torch, device)
        dist.destroy_process_group()
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def torchrun(n: int, spec: dict, tmp: str):
    """Start dist_worker on n ranks of this machine through torchrun;
    ``torchrun_results`` waits for it."""
    out = os.path.join(tmp, f"{spec['task']}-{n}-{len(os.listdir(tmp))}")
    os.makedirs(out)
    path = os.path.join(out, "spec.json")
    with open(path, "w") as f:
        json.dump(dict(spec, out=out), f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), os.path.abspath(__file__),
           "--dist-worker", path]
    return n, out, spec["task"], subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)


def torchrun_results(run, timeout: float) -> list:
    """Each rank's results of a ``torchrun``. A run that fails or
    outlasts `timeout` raises (its process group is killed)."""
    import signal
    n, out, task, p = run
    try:
        text, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        text, _ = p.communicate()
        raise RuntimeError(f"torchrun {task} on {n} ranks outlasted "
                           f"{timeout} s:\n{text[-4000:]}")
    if p.returncode:
        raise RuntimeError(f"torchrun {task} on {n} ranks: exit "
                           f"{p.returncode}\n{text[-4000:]}")
    return [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(n)]


def phase_distributed(torch, smi: str) -> dict:
    """Phase 16: the runner across processes, (a) one rank over NCCL, (b)
    two ranks sharing the card over gloo, 2x1 and 1x2, (c) the fused bf16
    chunk on the same two ranks. Returns launches by path and rank."""
    import tempfile
    from biear_tpu_torch import train_biear
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.models import ActiveBiEAR
    from biear_tpu_torch.train.runner import train

    label = f"({smi}; two processes share one card: no scaling claim)"
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        rc = dist_run_config(os.path.join(tmp, "ref"), (-1, 1))
        synth = train_biear.make_synth(rc)
        LAUNCHES.clear()
        ref = train(rc, synth=synth, run_id="ref", quiet=True)
        torch.cuda.synchronize()
        # captured, as every rank of a mesh without a model axis: each
        # capture's warm-up adds WARMUP_STEPS calls' launches
        ref_launches = dict(LAUNCHES)
        want = step_scalars(ref["run_dir"])
        log(f"distributed: reference runner (no process group, captured), "
            f"{RUNNER_STEPS} steps at batch {rc.batch_size}, dropout 0: "
            f"per-step losses and gradient norms {json.dumps(want)}; "
            f"launches {ref_launches}; "
            f"{RUNNER_STEPS * rc.batch_size / ref['history']['train'][0]['sec']!r}"
            f" utt/s ({smi})")
        del ref
        torch.cuda.empty_cache()

        # (b)'s probe: two ranks on one card over NCCL, beside (a)
        probe = torchrun(2, {"task": "nccl-probe"}, tmp)
        # (a) one rank over NCCL
        a, = torchrun_results(torchrun(1, {"task": "runs", "runs": [{
            "name": "nccl-1x1", "mesh": [1, 1],
            "root": os.path.join(tmp, "a")}]}, tmp), 300)
        run = a["runs"]["nccl-1x1"]
        got = step_scalars(run["run_dir"])
        launches["dist_nccl_1x1"] = run["launches"]
        log(f"distributed (a) torchrun 1 rank, backend {a['backend']}, "
            f"captured: per-step losses {got['loss']!r}; losses and "
            f"gradient norms equal to the reference bit for bit: "
            f"{got == want}; launches {run['launches']} (the captured "
            f"reference's: {run['launches'] == ref_launches}); "
            f"{run['utt_s_per_rank']!r} utt/s; flat all-reduce "
            f"{json.dumps(run['allreduce'])} ({smi})")
        if (a["backend"] != "nccl" or got != want
                or run["launches"] != ref_launches):
            raise RuntimeError("distributed (a): the NCCL world of one "
                               "differs from the captured runner without a "
                               "group")

        # (b) two ranks on one card: NCCL refuses, gloo on CUDA tensors
        for r in torchrun_results(probe, 150):
            log(f"distributed (b) NCCL probe, 2 ranks on one card, rank "
                f"{r['rank']}: {r['error']}")
        ranks = torchrun_results(torchrun(2, {
            "task": "runs", "backend": "gloo", "chunk": True,
            "runs": [{"name": f"gloo-{d}x{m}", "mesh": [d, m],
                      "root": os.path.join(tmp, f"{d}x{m}")}
                     for d, m in ((2, 1), (1, 2))]}, tmp), 600)
        for name in ranks[0]["runs"]:
            runs = [r["runs"][name] for r in ranks]
            got = step_scalars(runs[0]["run_dir"])
            root = os.path.dirname(runs[0]["run_dir"])
            trees = os.listdir(root)
            check_run_tree(runs[0]["run_dir"], name)
            model = ActiveBiEAR(rc.model_cfg).cuda()
            model.load_state_dict(torch.load(os.path.join(
                runs[0]["run_dir"], "checkpoints", "best", "params.pth"),
                weights_only=True), strict=True)
            err = {k: max_rel(got[k][:DIST_STEPS_HELD[k]],
                              want[k][:DIST_STEPS_HELD[k]])
                   for k in DIST_SCALARS}
            fb_drift = max_rel(got["grad_fb_norm"], want["grad_fb_norm"])
            for r, x in zip(ranks, runs):
                launches[f"dist_{name}_rank{r['rank']}"] = x["launches"]
            # 2x1 is captured (the reference's launches, warm-ups
            # included, on each rank); 1x2 runs eagerly
            captured = [x["launches"] == ref_launches for x in runs]
            log(f"distributed (b) {name} over {ranks[0]['backend']}: "
                f"per-step losses {got['loss']!r}, gradient norms (fb, "
                f"backend) {got['grad_fb_norm']!r}, "
                f"{got['grad_backend_norm']!r}; captured (launches equal "
                f"the captured reference's) {captured}; max relative "
                f"differences "
                f"from the reference {json.dumps(err)} (limits "
                f"{json.dumps(DIST_RTOL)}, steps held "
                f"{json.dumps(DIST_STEPS_HELD)}; the frontend's norm over "
                f"every step {fb_drift!r}, not held); run "
                f"trees {trees}; best.pth loads strictly; launches per "
                f"rank {[x['launches'] for x in runs]}; utt/s per rank "
                f"{[x['utt_s_per_rank'] for x in runs]!r}; flat all-reduce "
                f"{[x['allreduce'] for x in runs]} {label}")
            if (any(len(got[k]) != len(want[k]) or err[k] > DIST_RTOL[k]
                    for k in DIST_SCALARS)
                    or len(trees) != 1
                    or any(x["history"] != runs[0]["history"]
                           for x in runs)
                    or captured != [name == "gloo-2x1"] * len(runs)):
                raise RuntimeError(f"distributed (b) {name}: {got}, "
                                   f"trees {trees}")
        for r in ranks:
            c = r["chunk"]
            launches[f"dist_chunk_bf16_rank{r['rank']}"] = c["launches"]
            log(f"distributed (c) rank {r['rank']}: bf16 chunk, "
                f"{DIST_CHUNKS} chunks of {DIST_CHUNK_STEPS} steps at "
                f"{DIST_RANK_BATCH} rows per rank (global "
                f"{2 * DIST_RANK_BATCH}), captured (two graphs a step around "
                f"the gloo all-reduce) against capture=False: batches and "
                f"generator states bit for bit; losses off by "
                f"{c['loss_err'][0]!r} (witness spread "
                f"{c['loss_err'][1]!r}), parameters {c['param_err'][0]!r} "
                f"({c['param_err'][1]!r}); launches per captured chunk "
                f"{c['launches']}, per eager chunk {c['eager_launches']}; "
                f"capture {json.dumps(c['stats'])}; utt/s per rank captured "
                f"{c['captured_utt_s_per_rank']!r}, eager "
                f"{c['eager_utt_s_per_rank']!r}; profile of one chunk "
                f"(rank 0) {json.dumps(c['profile'])}; losses "
                f"{c['losses']!r} {label}")
            if any(c[p].get(k, 0) != DIST_CHUNK_STEPS
                   for k in ("gather_mix_kb", "cc_lags")
                   for p in ("launches", "eager_launches")):
                raise RuntimeError(f"distributed (c): {c}")
        if not all(any(c.get(k, 0) for c in launches.values())
                   for k in ("cc_lags", "gather_windows", "gather_mix_kb")):
            raise RuntimeError(f"distributed: a kernel never launched "
                               f"{launches}")
    return launches


def precision_state(torch) -> tuple:
    """(cuBLAS TF32, cuDNN TF32, CUDA autocast on, its dtype, the port's
    process-wide MATMUL_PRECISION)."""
    from biear_tpu_torch.device import matmul_precision_name
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.is_autocast_enabled("cuda"),
            torch.get_autocast_dtype("cuda"), matmul_precision_name())


def phase_precision(torch, rng):
    """17: the bench's line at a reduced window count, every
    MATMUL_PRECISION name's forward and the reduced names' train steps,
    the DFT probe. Returns the bench path's launch counts."""
    from biear_tpu_torch import bench, probe_dft_matmul
    from biear_tpu_torch.device import (PRECISION_NAMES, TF32_NAMES,
                                        matmul_precision)
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.models import (BiEARConfig, build_active,
                                        build_passive)
    from biear_tpu_torch.train.loop import make_train_step
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer
    from biear_tpu_torch.train.profile_train import fixed_batch

    # (a)
    t0 = time.perf_counter()
    LAUNCHES.clear()
    line = bench.measure(steps=5, chunk_dispatches=1, windows=1)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    by_op = line.pop("flops_by_op")
    print(json.dumps({**line, "reduced": True}), flush=True)
    log(f"bench (a): {time.perf_counter() - t0:.1f} s, launches "
        f"{launches}, FLOPs per utterance by op {by_op}")
    if any(launches.get(k, 0) <= 0 for k in ("gather_mix_kb", "cc_lags")):
        raise RuntimeError(f"bench: a kernel of its path never launched "
                           f"{launches}")
    if not all(np.isfinite(line[k]) and line[k] > 0
               for k in ("value", "model_step_utt_s", "flops_per_utt",
                         "mfu")):
        raise RuntimeError(f"bench: {line}")

    # (b)
    cfg = BiEARConfig()
    model = build_active(cfg, seed=0)
    perturb_controllers(torch, model, seed=1)
    x = [torch.tensor(rng.uniform(-1, 1, (PRECISION_BATCH, n)),
                      dtype=torch.float32, device="cuda")
         for n in (cfg.fs, cfg.fs, cfg.n_bands)]
    before = precision_state(torch)
    outs = {}
    for name in PRECISION_NAMES:
        with matmul_precision(name):
            inside = precision_state(torch)
            with torch.inference_mode():
                s, a, d, aux = model(*x)
        want = (name in TF32_NAMES, name in TF32_NAMES, name == "bfloat16")
        if inside[:3] != want or inside[4] != name:
            raise RuntimeError(f"{name}: state inside the block {inside}")
        if precision_state(torch) != before:
            raise RuntimeError(f"{name}: state not restored "
                               f"{precision_state(torch)} != {before}")
        outs[name] = {"Q": aux["Q"], "aoa": a, "sound": s, "dist": d}
    for name, out in outs.items():
        errs = {k: float((out[k] - outs["highest"][k]).abs().max())
                for k in PRECISION_TOL}
        log(f"precision (b) {name}: max |{name} - highest| {errs}")
        if any(not errs[k] <= PRECISION_TOL[k] for k in errs):
            raise RuntimeError(f"{name}: beyond {PRECISION_TOL}: {errs}")

    # (c)
    hp = TrainHyper()
    B = PRECISION_STEP_BATCH
    wave = fixed_batch(B, 100, 0, "cuda")
    planes = [torch.tensor(rng.uniform(lo, hi, (B, 19, 100)),
                           dtype=torch.float32, device="cuda")
              for lo, hi in ((-80, 0), (-80, 0), (-np.pi, np.pi),
                             (-np.pi, np.pi))]
    passive = (*planes[:2], wave[2], *planes[2:], wave[3])
    models = {"flagship": (lambda: build_active(
                  bench.flagship_config("bfloat16"), seed=0), wave),
              "auralnet": (lambda: serve_model(torch, "auralnet",
                                               "bfloat16"), wave),
              "passive": (lambda: build_passive(BiEARConfig(), seed=0),
                          passive)}
    for (label, (build, batch)), name in itertools.product(
            models.items(), ("tensorfloat32", "bfloat16")):
        m = build()
        step = make_train_step(m, hp, make_optimizer(m, hp))
        gen = torch.Generator(device="cuda").manual_seed(0)
        with matmul_precision(name):       # captured under the name
            got = step(batch, gen)
        got = {k: float(got[k]) for k in ("loss", "grad_fb_norm",
                                          "grad_backend_norm", "skipped")}
        log(f"precision (c) {label} {name}: train step at B={B}: {got}")
        if not all(np.isfinite(v) for v in got.values()) or got["skipped"]:
            raise RuntimeError(f"{label} {name}: train step {got}")
        if precision_state(torch) != before:
            raise RuntimeError(f"{name}: state not restored after a step")

    # (d)
    probe = probe_dft_matmul.probe(iters=DFT_PROBE_ITERS, repeats=1)
    for name, tol in DFT_PROBE_TOL.items():
        acc = probe[f"accuracy_{name}"]
        worst = max(c["max_abs_vs_specmax"] for c in acc.values())
        log(f"DFT probe (d) {name}: max error / spectrum max {worst!r} "
            f"(limit {tol}), {probe[f'ms_per_call_{name}']['median']!r} "
            f"ms per call (rfft "
            f"{probe['ms_per_call_rfft']['median']!r})")
        if not worst <= tol:
            raise RuntimeError(f"DFT probe {name}: {acc}")
    log(f"phase 17 in {time.perf_counter() - t0:.1f} s")
    return launches


def recording_batch_fn(torch, fn, steps: int):
    """fn (gen -> batch) wrapped to also copy batch i of a chunk into row
    i of (steps, ...) buffers (a device counter advanced by the call
    modulo `steps`, so a captured chunk's replays record as the eager
    calls do). Returns (the wrapper, the buffers, the counter, which the
    caller zeroes before each chunk)."""
    probe = fn(torch.Generator(device="cuda").manual_seed(12345))
    bufs = [torch.empty((steps, *t.shape), dtype=t.dtype, device=t.device)
            for t in probe]
    row = torch.zeros(1, dtype=torch.long, device="cuda")

    def run(gen):
        batch = fn(gen)
        for buf, t in zip(bufs, batch):
            buf.index_copy_(0, row, t[None])
        row.add_(1).remainder_(steps)
        return batch
    return run, bufs, row


def max_abs(torch, a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def capture_witness(torch, label: str, build, batch_fn, steps: int,
                    chunks: int, batch: int) -> dict:
    """Three copies of one seeded model: two eager chunks (capture=False,
    the witness pair) and one captured, each drawing from a generator
    re-seeded with CAPTURE_SEED + c before chunk c. After every chunk the
    captured run's batches and generator state equal the eager run's bit
    for bit; its losses and parameters lie within CAPTURE_WITNESS times
    the two eager runs' spread. Then a replay at lr_scale 0 leaves the
    parameters as they were, and a parameter given new storage makes the
    next call raise. Returns the launch counts of the captured chunks,
    their utt/s against the eager ones' and the capture's stats."""
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.train.loop import make_train_chunk
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer

    hp = TrainHyper()
    runs = {}
    for name, capture in (("eager", False), ("witness", False),
                          ("captured", True)):
        model = build()
        fn, bufs, row = recording_batch_fn(torch, batch_fn, steps)
        runs[name] = {"model": model, "bufs": bufs, "row": row,
                      "gen": torch.Generator(device="cuda"), "rates": [],
                      "chunk": make_train_chunk(model, hp,
                                                make_optimizer(model, hp),
                                                fn, steps, capture=capture)}
    cap = runs["captured"]
    cap["gen"].manual_seed(CAPTURE_SEED)
    cap["chunk"].capture(cap["gen"])
    stats = cap["chunk"].stats
    log(f"{label}: captured one synthesize -> step iteration at B={batch}: "
        f"warm-up {stats['warmup_ms']!r} ms, capture {stats['capture_ms']!r}"
        f" ms, pool {stats['pool_bytes'] / 1e9!r} GB")
    launches = {}
    worst = {"loss": (0.0, 0.0), "params": (0.0, 0.0)}
    for c in range(chunks):
        ms = {}
        for name, r in runs.items():
            r["gen"].manual_seed(CAPTURE_SEED + c)
            r["row"].zero_()
            torch.cuda.synchronize()
            if name == "captured":
                LAUNCHES.clear()
            t0 = time.perf_counter()
            ms[name] = r["chunk"](r["gen"])
            torch.cuda.synchronize()
            r["rates"].append(batch * steps / (time.perf_counter() - t0))
            if name == "captured":
                got = dict(LAUNCHES)
                for k, v in got.items():
                    launches[k] = launches.get(k, 0) + v
                if got.get("cc_lags", 0) != steps:
                    raise RuntimeError(f"{label} chunk {c}: cc_lags launched "
                                       f"{got.get('cc_lags', 0)} times in "
                                       f"{steps} replays")
        e, w, g = runs["eager"], runs["witness"], runs["captured"]
        for name in ("witness", "captured"):
            r = runs[name]
            if not all(torch.equal(a, b) for a, b in zip(r["bufs"],
                                                         e["bufs"])):
                raise RuntimeError(f"{label} chunk {c}: the {name} run's "
                                   "synthesised batches differ from the "
                                   "eager run's")
            if not torch.equal(r["gen"].get_state(), e["gen"].get_state()):
                raise RuntimeError(f"{label} chunk {c}: the {name} run's "
                                   "generator state differs")
        for key, got, want, wit in (
                ("loss", {"l": ms["captured"]["loss"]},
                 {"l": ms["eager"]["loss"]}, {"l": ms["witness"]["loss"]}),
                ("params", snapshot(g["model"]), snapshot(e["model"]),
                 snapshot(w["model"]))):
            err, spread = max_abs(torch, got, want), max_abs(torch, wit, want)
            worst[key] = (max(worst[key][0], err), max(worst[key][1], spread))
            if err > CAPTURE_WITNESS * spread:
                raise RuntimeError(
                    f"{label} chunk {c}: captured {key} off the eager run by "
                    f"{err!r}, {CAPTURE_WITNESS!r} x the witness spread "
                    f"{spread!r}")
        if not (bool(torch.isfinite(ms["captured"]["loss"]).all())
                and float(ms["captured"]["skipped"].sum()) == 0):
            raise RuntimeError(f"{label} chunk {c}: nonfinite loss or a "
                               "skipped step")
    log(f"{label}: {chunks} chunks of {steps} steps, batches and generator "
        f"bit for bit; captured vs eager (witness spread): losses "
        f"{worst['loss'][0]!r} ({worst['loss'][1]!r}), parameters "
        f"{worst['params'][0]!r} ({worst['params'][1]!r})")

    gen, chunk, model = cap["gen"], cap["chunk"], cap["model"]
    before = snapshot(model)
    chunk(gen, 0.0)
    if max_abs(torch, snapshot(model), before) != 0.0:
        raise RuntimeError(f"{label}: a replay at lr_scale 0 moved the "
                           "parameters")
    chunk(gen, 1.0)
    if max_abs(torch, snapshot(model), before) == 0.0:
        raise RuntimeError(f"{label}: a replay at lr_scale 1 after 0 left "
                           "the parameters")
    p = next(model.parameters())
    kept = p.data
    p.data = kept.clone()
    try:
        chunk(gen)
    except RuntimeError as err:
        if "new storage" not in str(err):
            raise
        log(f"{label}: a parameter with new storage is refused: "
            f"{str(err)[:80]}...")
    else:
        raise RuntimeError(f"{label}: a replay after a storage swap ran")
    finally:
        p.data = kept
    rate = {k: statistics.median(runs[k]["rates"][1:] or runs[k]["rates"])
            for k in ("eager", "captured")}
    return {"launches": launches, "fused_utt_s": rate, "stats": stats,
            "loss_err": worst["loss"], "param_err": worst["params"],
            "batch_fn": batch_fn}


def capture_side_by_side(torch, label: str, res: dict, cfg, batch: int,
                         steps: int) -> dict:
    """(c): the captured and the eager path of one policy side by side in
    this call: fused utt/s (from the witness chunks), bare-step utt/s
    (two windows of CAPTURE_BARE_STEPS steps on bench.py's fixed batch),
    and torch.profiler over one chunk of CAPTURE_PROFILED_STEPS steps of
    each path (the profiler's cost per event makes a whole chunk slow to
    trace): device busy ms and kernels per step, idle share (under the
    profiler), host launches per chunk of those steps."""
    from biear_tpu_torch.models import build_active
    from biear_tpu_torch.serve.profile_serve import device_profile
    from biear_tpu_torch.train.loop import make_train_chunk, make_train_step
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer
    from biear_tpu_torch.train.profile_train import fixed_batch, rate_windows

    hp = TrainHyper()
    fb = fixed_batch(batch, cfg.n_bands, 0, "cuda")
    out = {"fused_utt_s": res["fused_utt_s"]}
    for name, capture in (("captured", True), ("eager", False)):
        model = build_active(cfg, seed=0)
        step_opt = make_optimizer(model, hp)
        step = make_train_step(model, hp, step_opt, capture=capture)
        gen = torch.Generator(device="cuda").manual_seed(0)
        step(fb, gen)
        bare = rate_windows(
            lambda: [step(fb, gen) for _ in range(CAPTURE_BARE_STEPS)],
            batch * CAPTURE_BARE_STEPS, 2)
        n = CAPTURE_PROFILED_STEPS
        chunk = make_train_chunk(model, hp, step_opt, res["batch_fn"], n,
                                 capture=capture)
        prof = device_profile(lambda: chunk(gen), calls=1)
        out[name] = {
            "bare_utt_s": bare["median"], "bare_windows": bare["windows"],
            "profiled_steps": n,
            "step_wall_ms": prof["wall_ms_per_call"] / n,
            "busy_ms_per_step": prof["device_busy_ms_per_call"] / n,
            "idle_share": prof["device_idle_share"],
            "kernels_per_step": prof["kernels_per_call"] / n,
            "host_launches_per_chunk": prof["host_launches_per_call"]}
        if capture:
            out[name]["step_capture"] = list(step.stats.values())
            out[name]["profiled_chunk_capture"] = chunk.stats
    out["chunk_capture"] = res["stats"]
    log(f"{label} captured vs eager: {json.dumps(out)}")
    return out


def phase_capture(torch, synth, smi: str) -> dict:
    """18: the train chunk as a captured CUDA graph against the eager
    loop. (a) the flagship at TRAIN_BATCH, bf16 and f32 policies,
    CAPTURE_CHUNKS chunks of CAPTURE_STEPS steps (``capture_witness``);
    (b) single, passive, AuralNet and the spirit scene, one chunk of
    CAPTURE_FAMILY_STEPS steps each; (c) both paths measured side by
    side, per policy (``capture_side_by_side``). Returns the captured
    chunks' launch counts."""
    from biear_tpu_torch.bench import flagship_config
    from biear_tpu_torch.data.passive_synth import PassiveFeatureSynth
    from biear_tpu_torch.data.synth import build_synthesizer, make_test_segments
    from biear_tpu_torch.models import (BiEARConfig, build_active,
                                        build_auralnet, build_passive)
    from biear_tpu_torch.serve.profile_serve import AURALNET, GEOMETRY

    launches, report = {}, {}
    synths = {"bfloat16": synth, "float32": training_synth(torch, "float32")}
    for policy, kernel in (("bfloat16", "gather_mix_kb"),
                           ("float32", "gather_windows")):
        cfg = flagship_config(policy)
        res = capture_witness(
            torch, f"capture flagship {policy}",
            lambda: build_active(cfg, seed=0),
            synths[policy].batch_fn(TRAIN_BATCH), CAPTURE_STEPS,
            CAPTURE_CHUNKS, TRAIN_BATCH)
        got = res["launches"]
        want = CAPTURE_CHUNKS * CAPTURE_STEPS
        if got.get(kernel, 0) != want or got.get("cc_lags", 0) != want:
            raise RuntimeError(f"capture {policy}: launches {got}, expected "
                               f"{want} of {kernel} and cc_lags")
        launches[f"capture_{policy}"] = got
        report[policy] = capture_side_by_side(torch, f"flagship {policy}",
                                              res, cfg, TRAIN_BATCH,
                                              CAPTURE_STEPS)
    single = BiEARConfig(**GEOMETRY["single"], fb_w_dtype="bfloat16")
    auralnet = BiEARConfig(**AURALNET, fb_w_dtype="bfloat16")
    passive = BiEARConfig(fb_w_dtype="bfloat16")
    spirit = build_synthesizer("spirit", None, make_test_segments(64), 16000,
                               num_lags=100)
    for label, build, fn, B in (
            ("single", lambda: build_active(single, seed=0),
             synth.batch_fn(TRAIN_BATCH), TRAIN_BATCH),
            ("passive", lambda: build_passive(passive, seed=0),
             PassiveFeatureSynth(synth).batch_fn(TRAIN_BATCH), TRAIN_BATCH),
            ("auralnet", lambda: build_auralnet(auralnet, seed=0),
             synth.batch_fn(TRAIN_BATCH), TRAIN_BATCH),
            ("spirit", lambda: build_active(flagship_config(), seed=0),
             spirit.batch_fn(REVERB_BATCH), REVERB_BATCH)):
        res = capture_witness(torch, f"capture {label}", build, fn,
                              CAPTURE_FAMILY_STEPS, 1, B)
        launches[f"capture_{label}"] = res["launches"]
        report[label] = {"fused_utt_s": res["fused_utt_s"],
                         "capture": res["stats"],
                         "loss_err": res["loss_err"],
                         "param_err": res["param_err"]}
    log(f"capture report ({smi}): {json.dumps(report)}")
    return launches


def witness_check(torch, label: str, got, eager, witness) -> tuple:
    """(max |captured - eager|, max |eager - eager|) over matching
    tensors; raises past CAPTURE_WITNESS times the witness spread."""
    dev = lambda a, b: max(float((x.float() - y.float()).abs().max())
                           for x, y in zip(a, b))
    err, spread = dev(got, eager), dev(witness, eager)
    if err > CAPTURE_WITNESS * spread:
        raise RuntimeError(f"{label}: captured off the eager path by "
                           f"{err!r}, {CAPTURE_WITNESS!r} x the witness "
                           f"spread {spread!r}")
    return err, spread


def synced_ms(torch, fn, reps: int = INFER_REPS) -> float:
    """Median host ms of `reps` synchronised calls of fn (after one)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def infer_predict(torch, rng) -> tuple:
    """19 (a): predict captured against capture=False for each of
    INFER_FAMILIES at SERVE_BATCHES. Returns (the captured calls' launch
    counts, the report)."""
    from biear_tpu_torch.device import matmul_precision
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.serve.infer import predict
    from biear_tpu_torch.serve.profile_serve import device_profile
    from biear_tpu_torch.graph import WARMUP_STEPS, pool_stats

    launches, report = {}, {}
    wav = {B: [torch.tensor(rng.uniform(-1, 1, (B, 16000)),
                            dtype=torch.float32, device="cuda")
               for _ in range(2)] for B in (1, 64, 512)}
    for label in INFER_FAMILIES:
        models = {dt: serve_model(torch, label, dt)
                  for dt in ("bfloat16", "float32")}
        for B, dt in SERVE_BATCHES:
            model, (wl, wr) = models[dt], wav[B]
            eager = predict(model, wl, wr, capture=False)
            witness = predict(model, wl, wr, capture=False)
            LAUNCHES.clear()
            first = predict(model, wl, wr)
            torch.cuda.synchronize()
            n_first = LAUNCHES.get("cc_lags", 0)
            LAUNCHES.clear()
            again = predict(model, wl.cpu().numpy(), wr.cpu().numpy())
            torch.cuda.synchronize()
            n_again = LAUNCHES.get("cc_lags", 0)
            for k, v in LAUNCHES.items():
                launches[k] = launches.get(k, 0) + v
            if (n_first, n_again) != (1 + WARMUP_STEPS, 1):
                raise RuntimeError(f"predict {label} B={B} {dt}: cc_lags "
                                   f"launched {n_first} times in the first "
                                   f"call, {n_again} in a replay")
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise RuntimeError(f"predict {label} B={B} {dt}: two "
                                   "replays (tensor and numpy inputs) differ")
            err, spread = witness_check(torch, f"predict {label} B={B} {dt}",
                                        again, eager, witness)
            check_outputs(torch, again, B)
            row = {"max_abs_vs_eager": err, "eager_spread": spread,
                   "bitwise": err == 0.0,
                   "captured_ms": synced_ms(torch, lambda: predict(
                       model, wl, wr)),
                   "eager_ms": synced_ms(torch, lambda: predict(
                       model, wl, wr, capture=False))}
            if B == 512:
                for name, cap in (("captured", None), ("eager", False)):
                    prof = device_profile(lambda: predict(
                        model, wl, wr, capture=cap), calls=3, top=3)
                    row[name + "_profile"] = {
                        k: prof[k] for k in (
                            "wall_ms_per_call", "device_busy_ms_per_call",
                            "device_idle_share", "kernels_per_call",
                            "host_launches_per_call")}
            report[f"{label} B={B} {dt}"] = row
            log(f"predict {label} B={B} {dt}: {json.dumps(row)}")
        model = models["bfloat16"]
        n = len(pool_stats(model)["predict"])
        with matmul_precision("bfloat16"):
            got = predict(model, *wav[64])
            want = predict(model, *wav[64], capture=False)
        n_new = len(pool_stats(model)["predict"]) - n
        d = max(float((a - b).abs().max()) for a, b in zip(got, want))
        log(f"predict {label} B=64 under MATMUL_PRECISION bfloat16: "
            f"{n_new} new graph, max |captured - eager| {d!r}")
        if n_new != 1 or not d <= SERVE_TOL["bfloat16"]:
            raise RuntimeError(f"predict {label}: a new precision did not "
                               "capture a new graph, or differs")
        check_outputs(torch, got, 64)
        report[f"{label} graphs"] = pool_stats(model)
        report[f"{label} f32 graphs"] = pool_stats(models["float32"])
    return launches, report


def infer_stream(torch, rng) -> dict:
    """19 (b): stream_step captured against capture=False for each of
    STREAM_MODES at STREAM_BATCHES, T hops and the readout with its tail,
    the state checked hop by hop; a state held from hop 4 unchanged after
    the rest; churn through the masked reset checked as phase 8's; ms and
    host launches per hop both ways, real-time factor."""
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.serve.profile_serve import GEOMETRY, device_profile
    from biear_tpu_torch.serve.profile_stream import Streams
    from biear_tpu_torch.serve.streaming import (_leaves, stream_init,
                                                 stream_plan, stream_readout,
                                                 stream_reset, stream_step)
    from biear_tpu_torch.graph import pool_stats

    report = {}
    for mode, fixed in STREAM_MODES:
        cfg = BiEARConfig(**GEOMETRY[mode], fixed_frontend_q=fixed,
                          fb_w_dtype="bfloat16")
        model = build_active(cfg, seed=0)
        perturb_controllers(torch, model, seed=1)
        plan = stream_plan(cfg)
        hop, T = plan["hop"], cfg.timesteps
        hop_ms = 1e3 * hop / cfg.fs
        label = f"{mode}{' fixed-Q' if fixed else ''}"
        for B in STREAM_BATCHES:
            wl, wr = (torch.tensor(rng.uniform(-1, 1, (B, cfg.fs)),
                                   dtype=torch.float32, device="cuda")
                      for _ in range(2))
            # each hop's chunks in their own (aligned) memory: the eager
            # hop on a view at a sample offset may take other cuBLAS and
            # cuFFT kernels than on the graph's static buffers
            chunks = [tuple(w[:, t * hop:(t + 1) * hop].clone()
                            for w in (wl, wr)) for t in range(T)]
            cap = eag = wit = stream_init(model, B)
            worst = (0.0, 0.0)
            for t, (cl, cr) in enumerate(chunks):
                cap = stream_step(model, cap, cl, cr)
                eag = stream_step(model, eag, cl, cr, capture=False)
                wit = stream_step(model, wit, cl, cr, capture=False)
                e = witness_check(torch, f"stream {label} B={B} hop {t}",
                                  _leaves(cap), _leaves(eag), _leaves(wit))
                worst = (max(worst[0], e[0]), max(worst[1], e[1]))
                if t == 4:
                    held, snap = cap, [x.clone() for x in _leaves(cap)]
            if not all(torch.equal(a, b) for a, b in zip(_leaves(held),
                                                         snap)):
                raise RuntimeError(f"stream {label} B={B}: a held state "
                                   "changed under later hops")
            tail = slice(T * hop, T * hop + plan["tail_len"])
            outs = [stream_readout(model, s, wl[:, tail], wr[:, tail])
                    for s in (cap, eag, wit)]
            r_err = witness_check(torch, f"stream {label} B={B} readout",
                                  *outs)
            row = {"state_max_abs_vs_eager": worst[0],
                   "state_eager_spread": worst[1],
                   "readout_max_abs_vs_eager": r_err[0]}
            for name, capture in (("captured", None), ("eager", False)):
                streams = Streams(model, B, False, capture=capture)
                ms = synced_ms(torch, streams.hop)
                prof = device_profile(streams.hop, calls=4, top=3)
                row[name] = {"ms_per_hop": ms, "rtf": hop_ms / ms,
                             "host_launches_per_hop":
                                 prof["host_launches_per_call"],
                             "kernels_per_hop": prof["kernels_per_call"],
                             "busy_ms_per_hop":
                                 prof["device_busy_ms_per_call"],
                             "idle_share": prof["device_idle_share"]}
            churn = Streams(model, B, True)
            row["captured_churn_ms_per_hop"] = synced_ms(torch, churn.hop)
            row["captured_churn_host_launches_per_hop"] = device_profile(
                churn.hop, calls=4, top=1)["host_launches_per_call"]
            report[f"{label} B={B}"] = row
            log(f"stream {label} B={B}: {json.dumps(row)}")
        # churn: half the slots reset after 9 hops equal fresh streams fed
        # the same audio, bit for bit (phase 8's check, captured hops)
        B = 64
        wl, wr = (torch.tensor(rng.uniform(-1, 1, (B, cfg.fs)),
                               dtype=torch.float32, device="cuda")
                  for _ in range(2))

        def hops(state, t0, n):
            for t in range(t0, t0 + n):
                sl = slice(t * hop, (t + 1) * hop)
                state = stream_step(model, state, wl[:, sl], wr[:, sl])
            return state

        mask = torch.arange(B, device="cuda") % 2 == 0
        churned = stream_reset(model, hops(stream_init(model, B), 0, 9), mask)
        got = stream_readout(model, hops(churned, 9, 10))
        ref = stream_readout(model, hops(stream_init(model, B), 9, 10))
        if not all(torch.equal(g[mask], r[mask]) for g, r in zip(got, ref)):
            raise RuntimeError(f"stream churn {label}: reset slots differ "
                               "from fresh streams")
        report[f"{label} graphs"] = pool_stats(model)
        log(f"stream churn {label}: {int(mask.sum())} reset slots equal "
            "fresh streams bit for bit (captured hops, masked reset)")
    return report


class ArrayRows:
    """numpy arrays as a dataset with rows() / len()."""

    def __init__(self, arrays):
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays[0])

    def rows(self, idx):
        return tuple(a[idx] for a in self.arrays)


def infer_eval(torch, synth) -> dict:
    """19 (c): the runner's val split (INFER_EVAL_ROWS synthesised rows,
    batch 64, stacked) through the captured eval chunk against the eager
    eval step batch by batch (per-batch metrics within the witness, the
    split's means, seconds both ways); collect_predictions for the active,
    AuralNet and passive models, captured against capture=False."""
    from biear_tpu_torch.bench import flagship_config
    from biear_tpu_torch.data.passive_synth import PassiveFeatureSynth
    from biear_tpu_torch.graph import pool_stats
    from biear_tpu_torch.models import (BiEARConfig, build_active,
                                        build_auralnet, build_passive)
    from biear_tpu_torch.serve.profile_serve import AURALNET
    from biear_tpu_torch.train import evaluate as ev
    from biear_tpu_torch.train.loop import make_eval_chunk, make_eval_step
    from biear_tpu_torch.train.optim import TrainHyper
    from biear_tpu_torch.train.runner import (SynthEvalDataset, _accumulate,
                                              _finalize)

    report = {}
    hp = TrainHyper()
    model = build_active(flagship_config("float32"), seed=0)
    ds = SynthEvalDataset(synth, INFER_EVAL_ROWS, 101, 64)
    chunk = make_eval_chunk(model, hp)
    steps = {"eager": make_eval_step(model, hp, capture=False),
             "witness": make_eval_step(model, hp, capture=False)}
    res, secs = {}, {}
    split_bytes = sum(t.numel() * t.element_size()
                      for g in ds.stacked_groups for t in g)
    torch.cuda.synchronize()
    base, held = torch.cuda.memory_allocated(), None
    for name in ("captured", "captured", "eager", "witness"):
        sums, per = {}, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "captured":
            for g in ds.stacked_groups:
                ms = chunk(g)
                per.append(ms)
                _accumulate(sums, ms, g[0].shape[1])
        else:
            for b in ds.device_batches():
                ms = steps[name](b)
                per.append(ms)
                _accumulate(sums, ms, b[0].shape[0])
        out = _finalize(sums)
        secs.setdefault(name, []).append(time.perf_counter() - t0)
        if held is None:
            # after the capturing eval: the split is read in place, so the
            # card holds it once, plus the eval graph's pool (no copy into
            # static buffers)
            held = torch.cuda.memory_allocated() - base
        res[name] = (out, {k: torch.cat([m[k].reshape(-1) for m in per])
                           for k in per[0]})
    err = witness_check(torch, "eval chunk", *(
        [v[1][k] for k in sorted(v[1])]
        for v in (res["captured"], res["eager"], res["witness"])))
    means = {k: (res["captured"][0][k], res["eager"][0][k])
             for k in res["eager"][0]}
    pool = pool_stats(model)["pool_bytes"]
    report["val_split"] = {"rows": INFER_EVAL_ROWS,
                           "groups": len(ds.stacked_groups),
                           "split_bytes": split_bytes,
                           "bytes_held_after_first_eval": held,
                           "eval_pool_bytes": pool,
                           "per_batch_max_abs": err[0],
                           "eager_spread": err[1], "means": means,
                           "captured_sec_first_and_second":
                               secs["captured"],
                           "eager_sec": secs["eager"][0]}
    log(f"eval chunk: {json.dumps(report['val_split'])}")
    if not all(abs(a - b) <= 1e-5 * max(1.0, abs(b))
               for a, b in means.values()):
        raise RuntimeError(f"eval chunk: split metrics {means}")
    if not held - pool < split_bytes // 2:
        raise RuntimeError(f"eval chunk: {held} bytes held after the first "
                           f"eval, beyond its pool's {pool}: the "
                           f"{split_bytes}-byte split was copied")

    gen = torch.Generator(device="cuda").manual_seed(7)
    wave = synth.sample_batch(gen, INFER_PREDICT_ROWS)
    feats = PassiveFeatureSynth(synth).sample_batch(gen, INFER_PREDICT_ROWS)
    for label, model, batch in (
            ("active", build_active(flagship_config(), seed=0), wave),
            ("auralnet", build_auralnet(BiEARConfig(
                **AURALNET, fb_w_dtype="bfloat16"), seed=0), wave),
            ("passive", build_passive(BiEARConfig(fb_w_dtype="bfloat16"),
                                      seed=0), feats)):
        rows = ArrayRows([t.cpu().numpy() for t in batch])
        t0 = time.perf_counter()
        got = ev.collect_predictions(model, rows, 64)
        cap_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = ev.collect_predictions(model, rows, 64, capture=False)
        eager_s = time.perf_counter() - t0
        wit = ev.collect_predictions(model, rows, 64, capture=False)
        err = witness_check(torch, f"collect_predictions {label}",
                            *([torch.as_tensor(a) for a in p[:3]]
                              for p in (got, want, wit)))
        report[f"collect_predictions {label}"] = {
            "max_abs_vs_eager": err[0], "eager_spread": err[1],
            "captured_s_first_call": cap_s, "eager_s": eager_s}
        log(f"collect_predictions {label}: "
            f"{json.dumps(report[f'collect_predictions {label}'])}")
    return report


def phase_infer_capture(torch, rng, synth, smi: str) -> dict:
    """19: the inference programs as captured CUDA graphs against their
    eager paths: (a) ``infer_predict``, (b) ``infer_stream``, (c)
    ``infer_eval``. Returns the captured predict calls' launch counts."""
    t0 = time.perf_counter()
    launches, report = infer_predict(torch, rng)
    report["stream"] = infer_stream(torch, rng)
    report["eval"] = infer_eval(torch, synth)
    report["seconds"] = time.perf_counter() - t0
    log(f"inference capture report ({smi}): {json.dumps(report)}")
    return {"infer_predict": launches}


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

    from biear_tpu_torch.kernels.build import build_all_with_report
    t0 = time.perf_counter()
    libs, compiler_log, ptxas = build_all_with_report()
    sys.stdout.write(compiler_log)
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    if not ptxas:
        log("no ptxas report: the build was up to date and compiled nothing")
    for e in ptxas:
        log(f"ptxas {e['kernel']} {e['entry']}: {e['registers']} registers, "
            f"{e['spill_stores']} bytes spill stores, {e['spill_loads']} "
            f"bytes spill loads, {e['stack']} bytes stack, {e['smem']} bytes "
            "static shared memory")
        if e["kernel"] in ("cc_lags", "gather_mix_kb") and (
                e["spill_stores"] or e["spill_loads"]):
            raise RuntimeError(f"{e['entry']} spills registers")

    rng = np.random.default_rng(0)
    max_err, timing = phase_kernels(torch, rng)
    synth = training_synth(torch, "bfloat16")
    errs, wtiming = phase_window_kernels(torch, synth)
    launches = {"serve": phase_serve(torch, rng)}
    launches.update(phase_train(torch, synth))
    launches["serve_single"] = phase_serve(torch, rng, "single")
    launches["train_single_bf16"] = train_chunk_phase(
        torch, synth, "single", SINGLE_TRAIN_STEPS)
    launches["stream"] = phase_stream(torch, rng)
    launches["evaluate"] = phase_evaluate(torch, synth)
    launches["runner"], runner_metrics = phase_runner(torch)
    launches.update(phase_passive(torch, synth))
    launches.update(phase_reverb(torch))
    launches.update(phase_auralnet(torch, rng, synth))
    import tempfile
    with tempfile.TemporaryDirectory() as work:
        got, runs = phase_protocol(torch, work)
        launches.update(got)
        launches.update(phase_dataset(torch, work, runs["auralnet"],
                                      runner_metrics))
    launches.update(phase_distributed(torch, smi))
    launches["bench"] = phase_precision(torch, rng)
    launches.update(phase_capture(torch, synth, smi))
    launches.update(phase_infer_capture(torch, rng, synth, smi))
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s (build "
        "included)")
    total = lambda k: sum(p.get(k, 0) for p in launches.values())
    by_path = lambda k: {p: c.get(k, 0) for p, c in launches.items()}

    kernels = [dict(name="cc_lags", route="cuda",
                    source="biear_tpu_torch/kernels/cc_lags.cu",
                    replaces="biear_tpu/ops/window_gather.py:250",
                    status="ported", launches=total("cc_lags"),
                    launches_by_path=by_path("cc_lags"),
                    max_abs_err=max_err, **timing),
               dict(name="gather_mix_kb", route="cuda",
                    source="biear_tpu_torch/kernels/gather_mix_kb.cu",
                    replaces="biear_tpu/ops/window_gather.py:118",
                    status="ported", launches=total("gather_mix_kb"),
                    launches_by_path=by_path("gather_mix_kb"),
                    max_abs_err=errs["gather_mix_kb"],
                    **wtiming["gather_mix_kb"]),
               dict(name="gather_windows", route="cuda",
                    source="biear_tpu_torch/kernels/gather_windows.cu",
                    replaces="biear_tpu/ops/window_gather.py:81",
                    status="ported", launches=total("gather_windows"),
                    launches_by_path=by_path("gather_windows"),
                    max_abs_err=errs["gather_windows"],
                    **wtiming["gather_windows"])]
    for k in kernels:
        k["ptxas"] = [{f: e[f] for f in ("registers", "spill_stores",
                                          "spill_loads", "smem")}
                      for e in ptxas if e["kernel"] == k["name"]]
        if k["launches"] <= 0:
            raise RuntimeError(f"{k['name']} never launched on a main path")
    print(f"chip_smoke total seconds: {time.perf_counter() - _START:.1f}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--dist-worker":
        sys.exit(dist_worker(sys.argv[2]))
    sys.exit(main())
