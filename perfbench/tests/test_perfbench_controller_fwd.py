"""The dual frontend's forward controller kernel's yardstick against hand
counts at the flagship's and the spirit cell's frames, and its reader on
made-up traces."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

sys.path.insert(0, tiny.ROOT)
from perfbench import bounds, harness  # noqa: E402
from perfbench.bounds import controller, frontend  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
A = (1024, 100, 128, 200)          # 2B rows, N, H, GRU inputs
D = (128, 100, 128, 200)


def _hand(rows, N=100, H=128, n_in=200):
    macs = 3 * H * n_in + 3 * H * H + 2 * H * H + N * H
    per_row = 4 * (N + H) + 2 * H + 4 * (n_in + 13 * H + 4 + 2 * N) \
        + 4 * (N + H)
    return rows * macs, rows * per_row + 8 * (macs + 12 * H + N)


@pytest.mark.parametrize("shape", [A, D])
def test_counts_at_the_cells_frames(shape):
    assert controller.controller_fwd(*shape) == pytest.approx(
        _hand(shape[0]))


def test_a_frame_of_the_flagship():
    # 171,520 multiply-adds a row: 3 x 128 x 200 + 5 x 128^2 + 100 x 128
    macs, nbytes = controller.controller_fwd(*A)
    assert macs == 1024 * 171520
    t, by = bounds.least_time(macs, nbytes, frontend.fma_peak(H100),
                              bounds.peak(H100, "hbm_bytes"))
    assert by == "operations" and t == pytest.approx(5.250e-6, rel=1e-3)
    assert nbytes / bounds.peak(H100, "hbm_bytes") == pytest.approx(
        3.578e-6, rel=1e-3)


def test_the_reader_takes_the_recorded_shape(monkeypatch):
    from biear_tpu_torch.models import controller as ctrl

    read = harness.reader("controller_fwd_roofline")
    name = ("void (anonymous namespace)::controller_fwd_kernel<4>("
            "(anonymous namespace)::Params)")
    least = bounds.least_time(*controller.controller_fwd(*A),
                              frontend.fma_peak(H100),
                              bounds.peak(H100, "hbm_bytes"))[0]
    ctx = {"device_kind": H100,
           "trace": {"ops": {name: [18 * 4 * least, 18], "other": [1.0, 1]}}}
    monkeypatch.setattr(ctrl, "LAUNCH_SHAPES", {A: 18})
    assert read(ctx) == pytest.approx(25.0, rel=1e-6)
    # no kernel in the window, no card, no peak: nothing read
    assert read({**ctx, "trace": {"ops": {"other": [1.0, 1]}}}) is None
    assert read({**ctx, "device_kind": "cpu"}) is None
    assert read({**ctx, "device_kind": "some other card"}) is None
    assert read({**ctx, "trace": None}) is None
    # two frame shapes in the record: nothing read
    monkeypatch.setattr(ctrl, "LAUNCH_SHAPES", {A: 18, D: 18})
    assert read(ctx) is None
    # a program whose controller module has no record: nothing read
    monkeypatch.delattr(ctrl, "LAUNCH_SHAPES")
    assert read(ctx) is None
    # nor without the module
    monkeypatch.setitem(sys.modules, "biear_tpu_torch.models.controller",
                        None)
    assert read(ctx) is None
