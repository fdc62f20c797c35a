"""The dual frontend's reverse-recurrence kernel's yardstick against hand
counts at the flagship's and the spirit cell's frames, and its reader on
made-up traces."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

sys.path.insert(0, tiny.ROOT)
from perfbench import bounds, harness  # noqa: E402
from perfbench.bounds import frontend  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
A = (1024, 100, 128, 200)          # 2B rows, N, H, GRU inputs
D = (128, 100, 128, 200)


def _hand(rows, with_ctrl, with_input, N=100, H=128):
    macs = (N * H + 2 * H * H) * with_ctrl
    macs += 3 * H * (H + N) * (with_ctrl and with_input)
    per_row = (9 * H + 4 + 3 * N + 12 * H + N) * with_ctrl
    per_row += H * (with_ctrl and with_input)
    weights = (N * H + 2 * H * H + 2 * H) * with_ctrl
    weights += 3 * H * (H + N) * (with_ctrl and with_input)
    nbytes = 4 * rows * per_row + 8 * weights
    nbytes += rows * (4 * 14 * N + N) * with_input
    return rows * macs, nbytes


@pytest.mark.parametrize("shape", [A, D])
@pytest.mark.parametrize("with_ctrl,with_input", [(True, True),
                                                  (False, True),
                                                  (True, False)])
def test_counts_at_the_cells_frames(shape, with_ctrl, with_input):
    got = frontend.frontend_bwd(*shape, with_ctrl, with_input)
    assert got == pytest.approx(_hand(shape[0], with_ctrl, with_input))


def test_a_full_frame_of_the_flagship():
    # 133,120 multiply-adds a row: 100 x 128 + 2 x 128^2 + 3 x 128 x 228
    macs, nbytes = frontend.frontend_bwd(*A, True, True)
    assert macs == 1024 * 133120
    assert frontend.fma_peak(H100) == pytest.approx(33.45e12, rel=1e-3)
    t, by = bounds.least_time(macs, nbytes, frontend.fma_peak(H100),
                              bounds.peak(H100, "hbm_bytes"))
    assert by == "bytes" and t == pytest.approx(5.998e-6, rel=1e-3)
    # the step's last frame runs no controller: bytes alone
    assert frontend.frontend_bwd(*A, False, True)[0] == 0
    assert frontend.fma_peak("some other card") is None


def test_the_reader_averages_the_recorded_launches(monkeypatch):
    from biear_tpu_torch.models import frontend_bwd as fbw

    read = harness.reader("frontend_bwd_roofline")
    name = ("void (anonymous namespace)::frontend_bwd_kernel<8>("
            "(anonymous namespace)::Params)")
    shapes = {A + (True, True): 17, A + (False, True): 1,
              A + (True, False): 1}
    least = sum(n * bounds.least_time(
        *frontend.frontend_bwd(*k), frontend.fma_peak(H100),
        bounds.peak(H100, "hbm_bytes"))[0] for k, n in shapes.items()) / 19
    ctx = {"device_kind": H100,
           "trace": {"ops": {name: [19 * 2 * least, 19], "other": [1.0, 1]}}}
    monkeypatch.setattr(fbw, "LAUNCH_SHAPES", shapes)
    assert read(ctx) == pytest.approx(50.0, rel=1e-6)
    # no kernel in the window, no card, no peak: nothing read
    assert read({**ctx, "trace": {"ops": {"other": [1.0, 1]}}}) is None
    assert read({**ctx, "device_kind": "cpu"}) is None
    assert read({**ctx, "device_kind": "some other card"}) is None
    assert read({**ctx, "trace": None}) is None
    # two frame shapes in the record: nothing read
    monkeypatch.setattr(fbw, "LAUNCH_SHAPES", {**shapes,
                                               D + (True, True): 17})
    assert read(ctx) is None
    # a program without the kernel's module: nothing read
    monkeypatch.setitem(sys.modules, "biear_tpu_torch.models.frontend_bwd",
                        None)
    assert read(ctx) is None
