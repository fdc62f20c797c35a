"""The frame spectra kernel's yardstick against hand counts at the cells'
launches, and its reader on made-up traces."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

sys.path.insert(0, tiny.ROOT)
from perfbench import bounds, harness  # noqa: E402
from perfbench.bounds import spectra  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
A = (1024, 19, 842, 513, "rhs")      # both ears of batch 512, one launch
B = (512, 19, 842, 513, "mag")       # AuralNet: one ear a launch
D = (128, 19, 842, 513, "rhs")
XS = (64, 19, 842, 513, "xs")        # the fixed-Q path's f32 spectra
PEAKS = (bounds.peak(H100, "f32_flops"), bounds.peak(H100, "hbm_bytes"))


@pytest.mark.parametrize("key,out_bytes", [(A, 8), (B, 4), (D, 8),
                                           (XS, 12)])
def test_counts_at_the_cells_launches(key, out_bytes):
    rows, T, win, F, _ = key
    ops = rows * T * (win + 5 * 512 * 9 + 20 * F)
    nbytes = rows * T * (4 * win + out_bytes * F)
    assert spectra.spectra(*key) == (pytest.approx(ops), nbytes)


def test_a_step_of_the_flagship_is_bound_by_its_bytes():
    # 65.5 MB of waveform read, 79.8 MB of bf16 [mag, re, im, 1] written
    ops, nbytes = spectra.spectra(*A)
    assert 4 * 1024 * 19 * 842 == pytest.approx(65.5e6, rel=1e-3)
    assert 8 * 1024 * 19 * 513 == pytest.approx(79.8e6, rel=1e-3)
    t, by = bounds.least_time(ops, nbytes, *PEAKS)
    assert by == "bytes" and t == pytest.approx(43.4e-6, rel=1e-3)
    assert ops / PEAKS[0] == pytest.approx(9.91e-6, rel=1e-3)


def _least(key):
    return bounds.least_time(*spectra.spectra(*key), *PEAKS)[0]


def test_the_reader_averages_the_recorded_launches(monkeypatch):
    from biear_tpu_torch.ops import spectra as sp

    read = harness.reader("spectra_roofline")
    name = ("void (anonymous namespace)::spectra_kernel<true>("
            "(anonymous namespace)::Frames, float const*, float2 const*, "
            "float2 const*, (anonymous namespace)::Out, int, int, int)")
    ctx = {"device_kind": H100,
           "trace": {"ops": {name: [8 * 4 * _least(A), 8], "other": [1, 1]}}}
    monkeypatch.setattr(sp, "LAUNCH_SHAPES", {A: 3})
    assert read(ctx) == pytest.approx(25.0, rel=1e-6)
    # AuralNet's two launches a step of one ear's magnitudes
    monkeypatch.setattr(sp, "LAUNCH_SHAPES", {B: 6})
    ctx_b = {**ctx, "trace": {"ops": {
        name.replace("<true>", "<false>"): [4 * 2 * _least(B), 4]}}}
    assert read(ctx_b) == pytest.approx(50.0, rel=1e-6)
    # two shapes: the least time averaged over the recorded launches
    monkeypatch.setattr(sp, "LAUNCH_SHAPES", {A: 1, D: 3})
    want = 100.0 * (_least(A) + 3 * _least(D)) / 4 / (4 * _least(A))
    assert read(ctx) == pytest.approx(want, rel=1e-6)
    # no kernel in the window, no card, no peak, no trace: nothing read
    assert read({**ctx, "trace": {"ops": {"other": [1.0, 1]}}}) is None
    assert read({**ctx, "device_kind": "cpu"}) is None
    assert read({**ctx, "device_kind": "some other card"}) is None
    assert read({**ctx, "trace": None}) is None
    # nothing recorded: nothing read
    monkeypatch.setattr(sp, "LAUNCH_SHAPES", {})
    assert read(ctx) is None
    # a program without the kernel's module (the parent): nothing read
    monkeypatch.setitem(sys.modules, "biear_tpu_torch.ops.spectra", None)
    assert read(ctx) is None
