"""The single frontend's reverse-recurrence kernel's yardstick against
hand counts at the single-controller cell's frame, and its reader on
made-up traces."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

sys.path.insert(0, tiny.ROOT)
from perfbench import bounds, harness  # noqa: E402
from perfbench.bounds import frontend, single  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
S = (512, 100, 128, 400)           # B controller rows, N, H, GRU inputs


def _hand(rows, with_ctrl, with_input, N=100, H=128):
    macs = (N * H + 2 * H * H) * with_ctrl
    macs += 3 * H * (H + 2 * N) * (with_ctrl and with_input)
    per_row = (9 * H + 4 + 3 * N + 12 * H + N) * with_ctrl
    per_row += H * (with_ctrl and with_input)
    weights = (N * H + 2 * H * H + 2 * H) * with_ctrl
    weights += 3 * H * (H + 2 * N) * (with_ctrl and with_input)
    nbytes = 4 * rows * per_row + 4 * weights
    # both ears' filterbank rows read 13 N floats and N mask bytes; each
    # controller row writes its gradient of Q
    nbytes += (2 * rows * (4 * 13 * N + N) + 4 * rows * N) * with_input
    return rows * macs, nbytes


@pytest.mark.parametrize("with_ctrl,with_input", [(True, True),
                                                  (False, True),
                                                  (True, False)])
def test_counts_at_the_cells_frame(with_ctrl, with_input):
    got = single.single_bwd(*S, with_ctrl, with_input)
    assert got == pytest.approx(_hand(S[0], with_ctrl, with_input))


def test_a_full_frame_of_the_single_cell():
    # 171,520 multiply-adds a row: 100 x 128 + 2 x 128^2 + 3 x 128 x 328
    macs, nbytes = single.single_bwd(*S, True, True)
    assert macs == 512 * 171520
    # 3,220 floats a controller row, 171,776 weights, 5,300 bytes a
    # filterbank row and 400 more a controller row
    assert nbytes == 4 * 512 * 3220 + 4 * 171776 + 1024 * 5300 + 512 * 400
    t, by = bounds.least_time(macs, nbytes, frontend.fma_peak(H100),
                              bounds.peak(H100, "hbm_bytes"))
    assert by == "bytes" and t == pytest.approx(3.852e-6, rel=1e-3)
    # the step's last frame runs no controller: bytes alone
    assert single.single_bwd(*S, False, True)[0] == 0


def test_the_reader_averages_the_recorded_launches(monkeypatch):
    from biear_tpu_torch.models import frontend_bwd as fbw

    read = harness.reader("single_bwd_roofline")
    name = ("void (anonymous namespace)::single_bwd_kernel<2>("
            "(anonymous namespace)::Params)")
    dual = ("void (anonymous namespace)::frontend_bwd_kernel<4>("
            "(anonymous namespace)::Params)")
    shapes = {S + (True, True): 17, S + (False, True): 1,
              S + (True, False): 1}
    least = sum(n * bounds.least_time(
        *single.single_bwd(*k), frontend.fma_peak(H100),
        bounds.peak(H100, "hbm_bytes"))[0] for k, n in shapes.items()) / 19
    ctx = {"device_kind": H100,
           "trace": {"ops": {name: [19 * 4 * least, 19], dual: [1.0, 19],
                             "other": [1.0, 1]}}}
    monkeypatch.setattr(fbw, "SINGLE_LAUNCH_SHAPES", shapes)
    assert read(ctx) == pytest.approx(25.0, rel=1e-6)
    # the dual entry's reader does not count the single entry's kernel
    monkeypatch.setattr(fbw, "LAUNCH_SHAPES", {})
    assert harness.reader("frontend_bwd_roofline")(
        {**ctx, "trace": {"ops": {name: [1.0, 19]}}}) is None
    # no kernel in the window, no card, no peak: nothing read
    assert read({**ctx, "trace": {"ops": {dual: [1.0, 19]}}}) is None
    assert read({**ctx, "device_kind": "cpu"}) is None
    assert read({**ctx, "device_kind": "some other card"}) is None
    assert read({**ctx, "trace": None}) is None
    # two frame shapes in the record: nothing read
    monkeypatch.setattr(fbw, "SINGLE_LAUNCH_SHAPES",
                        {**shapes, (64, 100, 128, 400, True, True): 17})
    assert read(ctx) is None
    # a program without the single entry's record (the parent's), or
    # without the kernel's module: nothing read
    monkeypatch.delattr(fbw, "SINGLE_LAUNCH_SHAPES")
    assert read(ctx) is None
    monkeypatch.setitem(sys.modules, "biear_tpu_torch.models.frontend_bwd",
                        None)
    assert read(ctx) is None
