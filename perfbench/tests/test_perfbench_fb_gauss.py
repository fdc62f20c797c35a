"""The adaptive filterbank kernel's yardstick against hand counts, and its
reader on made-up traces."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

sys.path.insert(0, tiny.ROOT)
from perfbench import bounds, harness  # noqa: E402
from perfbench.bounds import filterbank  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


def test_fb_gauss_at_the_flagship_frame():
    # R = 2B = 1,024 rows, 100 bands, 513 bins, with T: 52.5 M expf
    exps, nbytes = filterbank.fb_gauss(1024, 100, 513, True)
    assert exps == 1024 * 100 * 513
    rhs, q = 1024 * 4 * 513 * 2, 1024 * 100 * 4
    outs = 1024 * 100 * (5 * 4 + 1 + 4 * 4)
    assert nbytes == rhs + q + outs                 # 8.40 MB
    assert filterbank.exp_peak(H100) == pytest.approx(4.18176e12)
    t, by = bounds.least_time(exps, nbytes, filterbank.exp_peak(H100),
                              bounds.peak(H100, "hbm_bytes"))
    assert by == "operations" and t == pytest.approx(12.56e-6, rel=1e-3)
    # without T the outputs are 21 bytes a band
    assert filterbank.fb_gauss(128, 100, 513, False) == (
        128 * 100 * 513, 128 * 4 * 513 * 2 + 128 * 100 * 4 + 128 * 100 * 21)
    assert filterbank.exp_peak("some other card") is None


def test_the_reader_finds_the_kernel_and_its_one_shape(monkeypatch):
    from biear_tpu_torch.ops import filterbank as fb

    read = harness.reader("fb_gauss_roofline")
    name = ("void (anonymous namespace)::fb_gauss_kernel<true>(float "
            "const*, int, ...)")
    ctx = {"device_kind": H100,
           "trace": {"ops": {name: [19 * 25.12e-6, 19], "other": [1.0, 1]}}}
    monkeypatch.setattr(fb, "LAUNCH_SHAPES", {(1024, 100, 513, True): 3})
    assert read(ctx) == pytest.approx(50.0, rel=1e-3)
    # no kernel in the window, two shapes, no card, no peak: nothing read
    assert read({**ctx, "trace": {"ops": {"other": [1.0, 1]}}}) is None
    assert read({**ctx, "device_kind": "cpu"}) is None
    assert read({**ctx, "device_kind": "some other card"}) is None
    monkeypatch.setattr(fb, "LAUNCH_SHAPES", {(1024, 100, 513, True): 3,
                                              (64, 100, 513, False): 1})
    assert read(ctx) is None
