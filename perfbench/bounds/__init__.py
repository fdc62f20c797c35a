"""The yardstick's arithmetic: the card's peaks, each kernel's operations
and bytes from its shapes, a kernel's least time, and the FLOPs of a
train step.

Kernel formulas follow ``biear_tpu_torch/kernels/time_kernels.py`` (a
copy of its arithmetic; nothing of the port is imported): every input
byte counted once and every output byte once, whatever a kernel reads
again; the least time is the larger of operations over the peak rate
and bytes over the memory bandwidth.
"""

from __future__ import annotations

import numpy as np

# Published dense peaks of the SXM part without sparsity: NVIDIA H100
# data sheet (bf16 tensor cores, f32 outside the tensor cores, HBM3).
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12,
                                   "f32_flops": 67e12,
                                   "hbm_bytes": 3.35e12}}

WIN = 16384        # the mix kernel's window: 128 blocks of 128 samples


def peak(kind: str, key: str):
    """A peak of card `kind`, or None for a card not in the table."""
    return PEAKS.get(kind, {}).get(key)


def least_time(flops: float, nbytes: float, flop_rate: float,
               byte_rate: float) -> tuple:
    """(least seconds, "operations" or "bytes", whichever bounds it)."""
    t_op, t_b = flops / flop_rate, nbytes / byte_rate
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def cc_lags(rows: int, n: int, max_kept: int) -> tuple:
    """(FLOPs, bytes) of the kept-lag cross-correlation: both mean-removed
    ears read (rows, n) float32, every lag of 2K + 1 a dot product of n
    samples (a multiply and an add), the lags written."""
    lags = 2 * max_kept + 1
    return 2.0 * rows * lags * n, 4.0 * (2 * rows * n + rows * lags)


def window_bytes(rows, offs, row_len: int, win: int = WIN) -> float:
    """Bytes of the pool the windows cover: per distinct pool row, the
    span from its smallest to its largest offset plus one window, capped
    at the row (float32, read once)."""
    rows, offs = np.asarray(rows), np.clip(np.asarray(offs), 0,
                                           row_len - win)
    span = 0
    for u in np.unique(rows):
        o = offs[rows == u]
        span += min(int(o.max() - o.min()) + win, row_len)
    return 4.0 * span


def gather_mix_kb(windows: int, frames: int, kb_cols: int,
                  distinct_meas: int, pool_bytes: float) -> tuple:
    """(FLOPs, bytes) of the fused window gather and HRIR mix: each of
    `windows` windows of `frames` 128-sample frames times its
    measurement's block-Toeplitz tile (kb_cols x 256, bfloat16) into
    (frames, 256) float32 outputs; the pool spans read once, each distinct
    measurement's tile once, the outputs written."""
    flops = 2.0 * windows * frames * kb_cols * 256
    nbytes = (pool_bytes + distinct_meas * kb_cols * 256 * 2.0
              + windows * frames * 256 * 4.0)
    return flops, nbytes


def train_flops_per_utt(loss_fn, rows: int) -> float:
    """FLOPs per utterance that ``torch.utils.flop_counter`` counts (the
    products) in one forward and backward of `loss_fn` () -> (loss,
    leaves) over `rows` rows, as ``biear_tpu_torch/bench.py::
    train_flops_per_utt`` counts a step: elementwise work, reductions and
    FFTs count nothing. Every product's rows are batch rows, so the count
    per utterance does not depend on `rows`."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        loss, leaves = loss_fn()
        torch.autograd.grad(loss, leaves, allow_unused=True)
    return counter.get_total_flops() / rows
