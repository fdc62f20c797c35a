"""The yardstick's arithmetic against hand counts."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

sys.path.insert(0, tiny.ROOT)
from perfbench import bounds, devtrace  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


def test_cc_lags_at_batch_512():
    flops, nbytes = bounds.cc_lags(512, 16000, 48)
    assert flops == 2 * 512 * 97 * 16000          # 1.59 GFLOP
    assert nbytes == 4 * (2 * 512 * 16000 + 512 * 97)
    t, by = bounds.least_time(flops, nbytes,
                              bounds.peak(H100, "f32_flops"),
                              bounds.peak(H100, "hbm_bytes"))
    assert by == "operations" and t == pytest.approx(23.72e-6, rel=1e-3)


def test_gather_mix_kb_at_the_32_entry_bank():
    # 1,536 windows of 125 frames, a 384-column tile per measurement:
    # 17.4 MB of pool + 6.3 MB of tiles read, 196.6 MB written
    flops, nbytes = bounds.gather_mix_kb(1536, 125, 384, 32, 17.4e6)
    assert nbytes == pytest.approx(17.4e6 + 6.29e6 + 196.608e6, rel=1e-3)
    assert flops == 2 * 1536 * 125 * 384 * 256
    t, by = bounds.least_time(flops, nbytes,
                              bounds.peak(H100, "bf16_flops"),
                              bounds.peak(H100, "hbm_bytes"))
    assert by == "bytes" and t == pytest.approx(65.8e-6, rel=2e-3)


def test_window_bytes_counts_each_row_span_once():
    rows = np.array([0, 0, 1, 2, 2])
    offs = np.array([10, 250, 0, 5, 5])
    row = 17152
    want = 4 * ((240 + 16384) + 16384 + 16384)
    assert bounds.window_bytes(rows, offs, row) == want
    assert bounds.window_bytes([0], [row], row) == 4 * 16384


def test_peak_table():
    assert bounds.peak(H100, "bf16_flops") == 989.4e12
    assert bounds.peak("some other card", "bf16_flops") is None


def test_flop_count_of_a_linear_layer():
    w = torch.randn(7, 5, requires_grad=True)
    x = torch.randn(3, 5)
    per_row = bounds.train_flops_per_utt(lambda: ((x @ w.T).sum(), [w]), 3)
    assert per_row == 2 * 5 * 7 * 2      # forward and the weight's gradient


def test_busy_union_and_gaps():
    busy, gaps = devtrace._busy_and_gaps([(0, 10), (5, 20), (30, 40),
                                         (41, 42)])
    assert busy == pytest.approx(31e-6)
    assert gaps == [(20, 30), (40, 41)]
