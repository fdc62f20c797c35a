"""On the card: through the harness's own run, the control (the
program's TF32 path) comes out not correct and a sound run correct, in
each training cell at its own size, on three seeds. Skips without a
card, decided inside each test."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

sys.path.insert(0, tiny.ROOT)

pytestmark = pytest.mark.cuda

CELLS = ["dual-train-b512", "auralnet-train-b512", "dual-train-b64-spirit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_sound_passes(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perfbench.control import reading
    for seed in (1, 2, 3):
        sound = reading(cell, seed, "sound", 0.0, "cuda:0")
        ctl = reading(cell, seed, "control", 0.0, "cuda:0")
        assert sound["correct"] is True, sound["values"]
        assert ctl["correct"] is False, ctl["values"]
