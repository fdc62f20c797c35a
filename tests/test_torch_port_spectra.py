"""The frame spectra as one launch (``kernels/spectra.cu`` through
``ops/spectra.py``), and the dispatch that takes it.

On the CPU: where each spectra route runs (``models/frontend.py::
spectra_on_kernel``): under the bf16 policy "auto" is the DFT product on
the CPU, bit for bit what the frontend ran before the kernel, and the
kernel on the card; the f32 policy's "auto" is the rFFT; the explicit
"fft" and "matmul" keep their meaning. The plain filterbank operand
(``rhs_plain``) is the stack the frontend built before, and the kernel's
layout, (2B, T, 4, F) transposed, gives the same tensor. The CUDA entries
refuse what the kernel cannot take before they load the library. A numpy
emulation of the kernel's plan (the packed half-length FFT in radix-8,
then radix-4 or -2 Stockham passes, and the split into the bins) matches
the DFT at every n_fft the kernel takes. The kernel's yardstick
(``perfbench/bounds/spectra.py``) at the cells' shapes.

The tests marked ``cuda`` hold the kernel against the product and a
float64 rFFT at the flagship's shape (batch 512 an ear) and the spirit
cell's (64), in each output form (the bf16 operand of both ears, one
ear's f32 spectra, the magnitudes alone), at a stream hop (T = 1); two
launches and a graph's replays give the same bits; each spectra call is
one launch, and a model's forward launches it once (both ears) under the
bf16 policy, once an ear in AuralNet, and never under the f32 policy.
This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_spectra.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from biear_tpu_torch.kernels import LAUNCHES, build
from biear_tpu_torch.models import BiEARConfig
from biear_tpu_torch.models import frontend as tfe
from biear_tpu_torch.ops import spectra as sp
from biear_tpu_torch.ops.filterbank import stack_rhs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from perfbench import bounds  # noqa: E402
from perfbench.bounds import spectra as sbound  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


class _OnCard:
    """Stands in for a CUDA tensor in the dispatch predicate."""
    is_cuda = True


def _wav(B, seed, device="cpu", fs=16000):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((2, B, fs), generator=g, device=device) * 2 - 1


def _frames(cfg, B, seed, device="cpu"):
    c = tfe.device_constants(cfg, device)
    wav = _wav(B, seed, device, cfg.fs)
    return c, tfe.frames_of(cfg, wav[0], c), tfe.frames_of(cfg, wav[1], c)


# ------------------------------------------------------------ the CPU

@pytest.mark.parametrize("mode,dtype,where,route", [
    ("auto", "bfloat16", "card", "kernel"),
    ("auto", "bfloat16", "cpu", "matmul"),
    ("auto", "float32", "card", "fft"),
    ("auto", "float32", "cpu", "fft"),
    ("matmul", "bfloat16", "card", "matmul"),
    ("matmul", "float32", "card", "matmul"),
    ("fft", "bfloat16", "card", "fft"),
    ("fft", "float32", "cpu", "fft")])
def test_where_each_spectra_route_runs(mode, dtype, where, route):
    cfg = BiEARConfig(dft_mode=mode, fb_w_dtype=dtype)
    x = _OnCard() if where == "card" else torch.zeros(1, 842)
    on_kernel = tfe.spectra_on_kernel(cfg, x)
    assert on_kernel is (route == "kernel")
    assert cfg.use_dft_matmul is (route in ("kernel", "matmul"))


def test_the_cpu_bf16_auto_is_the_product_bit_for_bit():
    """What the frontend ran before the kernel: the f32 products of the
    frames with the windowed bases, sqrt(re^2 + im^2), then both ears'
    bf16 stacks concatenated and transposed to (T, 2B, 4, F)."""
    cfg = BiEARConfig(fb_w_dtype="bfloat16")
    c, fL, fR = _frames(cfg, 3, seed=1)
    old = []
    for f in (fL, fR):
        re, im = f @ c["dft_re"], f @ c["dft_im"]
        old.append((torch.sqrt(re * re + im * im), re, im))
    got = tfe.frame_spectra(cfg, fL, c)
    assert all(torch.equal(a, b) for a, b in zip(got, old[0]))
    want = torch.cat([stack_rhs(*old[0], True),
                      stack_rhs(*old[1], True)]).transpose(0, 1)
    rhs = tfe.frame_rhs(cfg, fL, fR, c)
    assert rhs.dtype == torch.bfloat16 and rhs.shape == (19, 6, 4, 513)
    assert torch.equal(rhs, want) and rhs.stride() == want.stride()
    # a stream hop: one frame an ear, (2B, 4, F)
    hop = tfe.frame_rhs(cfg, fL[:, 4], fR[:, 4], c)
    assert torch.equal(hop, want[4])
    # AuralNet's magnitudes are the same product's
    mag = tfe.spectra(cfg, _wav(3, 1)[0], c, mag_only=True)[0]
    assert torch.equal(mag, old[0][0])


@pytest.mark.parametrize("mode,dtype", [("auto", "float32"),
                                        ("fft", "bfloat16")])
def test_auto_under_f32_and_explicit_fft_are_the_rfft(mode, dtype):
    cfg = BiEARConfig(dft_mode=mode, fb_w_dtype=dtype)
    c, fL, _ = _frames(cfg, 2, seed=2)
    X = torch.fft.rfft(fL * c["window"], n=cfg.n_fft)
    got = tfe.frame_spectra(cfg, fL, c)
    assert all(torch.equal(a, b) for a, b in zip(got, (X.abs(), X.real,
                                                       X.imag)))


def test_explicit_matmul_under_f32_is_the_product():
    cfg = BiEARConfig(dft_mode="matmul", fb_w_dtype="float32")
    c, fL, fR = _frames(cfg, 2, seed=3)
    want = sp.dft_plain(fL, c["dft_re"], c["dft_im"])
    assert all(torch.equal(a, b) for a, b in
               zip(tfe.frame_spectra(cfg, fL, c), want))
    rhs = tfe.frame_rhs(cfg, fL, fR, c)
    assert rhs.dtype == torch.float32 and torch.equal(rhs[:, :2, 0], want[0]
                                                      .transpose(0, 1))


def test_the_kernels_layout_transposed_is_the_plain_stack():
    """The kernel writes (2B, T, 4, F), the left ear's rows first, planes
    [mag, re, im, 1]: transposed, the tensor and strides of rhs_plain."""
    cfg = BiEARConfig(fb_w_dtype="bfloat16")
    c, fL, fR = _frames(cfg, 2, seed=4)
    specs = [sp.dft_plain(f, c["dft_re"], c["dft_im"]) for f in (fL, fR)]
    want = sp.rhs_plain(*specs, True)
    B, T, F = 2, cfg.timesteps, cfg.n_freq
    out = torch.empty((2 * B, T, 4, F), dtype=torch.bfloat16)
    for ear, (mag, re, im) in enumerate(specs):
        rows = out[ear * B:(ear + 1) * B]
        for p, plane in enumerate((mag, re, im, torch.ones_like(mag))):
            rows[:, :, p] = plane.to(torch.bfloat16)
    got = out.transpose(0, 1)
    assert torch.equal(got, want) and got.stride() == want.stride()


def _refusal_cases():
    good = torch.zeros(2, 3, 842)
    return {
        "float64": (good.double(), TypeError, "float32"),
        "bfloat16": (good.bfloat16(), TypeError, "float32"),
        "grad": (good.clone().requires_grad_(), ValueError, "backward"),
        "strided samples": (torch.zeros(2, 3, 1684)[..., ::2], ValueError,
                            "contiguous"),
        "other window": (torch.zeros(2, 3, 841), ValueError, "842"),
        "empty": (torch.zeros(0, 3, 842), ValueError, "842"),
        "rank 4": (torch.zeros(1, 2, 3, 842), ValueError, "win"),
        "cpu": (good, ValueError, "CUDA"),
    }


@pytest.mark.parametrize("case", list(_refusal_cases()))
def test_the_cuda_entries_refuse_before_the_library(monkeypatch, case):
    calls = []
    monkeypatch.setattr(build, "spectra_lib", lambda: calls.append(1))
    LAUNCHES.clear()
    frames, err, match = _refusal_cases()[case]
    c = tfe.device_constants(BiEARConfig(fb_w_dtype="bfloat16"), "cpu")
    with pytest.raises(err, match=match):
        sp.spectra_cuda(frames, c, 1024)
    with pytest.raises(err, match=match):
        sp.rhs_cuda(frames, frames, c, 1024)
    assert calls == [] and LAUNCHES["spectra"] == 0


@pytest.mark.parametrize("n_fft", [0, 1, 1000, 8192])
def test_the_cuda_entries_refuse_an_n_fft_they_cannot_take(monkeypatch,
                                                           n_fft):
    monkeypatch.setattr(build, "spectra_lib", lambda: pytest.fail("loaded"))
    c = tfe.device_constants(BiEARConfig(fb_w_dtype="bfloat16"), "cpu")
    with pytest.raises(ValueError, match="power of two"):
        sp.spectra_cuda(torch.zeros(1, 842), c, n_fft)


def _emulate(frame, window, n_fft):
    """spectra.cu's plan in float64 numpy: fold the windowed frame on
    n_fft, pack even and odd samples as M = n_fft / 2 complex points,
    Stockham passes of radix 8 then one of 4 or 2 (sub-transform size ns,
    twiddle e^{-2 pi i r k step / M}, outputs to (j - k) R + k + r ns),
    then the split X[k] = E + e^{-2 pi i k / n_fft} O."""
    M = n_fft // 2
    x = np.zeros(-(-len(frame) // n_fft) * n_fft)
    x[:len(frame)] = frame * window
    x = x.reshape(-1, n_fft).sum(0)
    z = x[0::2] + 1j * x[1::2]
    tw = np.exp(-2j * np.pi * np.arange(M) / M)
    radices, ns = [], 1
    while ns * 8 <= M:
        radices.append(8)
        ns *= 8
    radices += [M // ns] if ns < M else []
    ns = 1
    for R in radices:
        stride, step = M // R, M // (ns * R)
        j = np.arange(stride)
        k = j & (ns - 1)
        v = np.stack([z[j + r * stride] * tw[r * k * step] for r in range(R)])
        v = np.fft.fft(v, axis=0)               # the in-register DFT of R
        out = np.empty_like(z)
        for r in range(R):
            out[(j - k) * R + k + r * ns] = v[r]
        z, ns = out, ns * R
    k = np.arange(M + 1)
    a, b = z[k % M], np.conj(z[(M - k) % M])
    return (a + b) / 2 + np.exp(-2j * np.pi * k / n_fft) * (a - b) / 2j


def test_the_device_constants_carry_the_twiddles():
    """The kernel's tables, beside (not in) the JAX frontend's constants:
    the roots of unity of the M-point FFT and of the split, in float64
    rounded to float32 (re, im) pairs."""
    c = tfe.device_constants(BiEARConfig(), "cpu")
    assert "fft_tw" not in tfe.frontend_constants(BiEARConfig())
    for key, n, d in (("fft_tw", 512, 512), ("rfft_tw", 513, 1024)):
        z = np.exp(-2j * np.pi * np.arange(n) / d)
        want = np.stack([z.real, z.imag], -1).astype(np.float32)
        assert c[key].dtype == torch.float32
        np.testing.assert_array_equal(c[key].numpy(), want)


@pytest.mark.parametrize("n_fft,win", [(2, 2), (4, 3), (8, 8), (16, 13),
                                       (32, 40), (64, 50), (128, 128),
                                       (256, 100), (1024, 842),
                                       (2048, 2000), (4096, 4000)])
def test_the_kernels_fft_plan_is_the_dft(n_fft, win):
    rng = np.random.default_rng(n_fft + win)
    x, w = rng.standard_normal(win), rng.random(win)
    n, k = np.arange(win)[:, None], np.arange(n_fft // 2 + 1)[None]
    want = (x * w) @ np.exp(-2j * np.pi * n * k / n_fft)
    got = _emulate(x, w, n_fft)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max() * n_fft


@pytest.mark.parametrize("cell,rows,launches,form,us,mb", [
    ("A", 1024, 1, "rhs", 43.4, 145.4),
    ("B", 512, 2, "mag", 31.5, 105.4),
    ("D", 128, 1, "rhs", 5.42, 18.2)])
def test_the_bound_at_the_cells_shapes(cell, rows, launches, form, us, mb):
    """A step's spectra at the flagship's frames (T 19, win 842, F 513):
    842 f32 samples read a frame; per bin 8 bytes of bf16 [mag, re, im, 1]
    (A and D, both ears in one launch) or 4 of f32 mag (B, one launch an
    ear). 34,142 operations a frame (the window, 5 M log2 M of the
    512-point FFT, 20 a bin for the split and the magnitude), 0.66 GFLOP
    at A, 9.9 us at 67e12/s: the bytes bound every cell."""
    assert sbound.frame_ops(842, 513) == 842 + 5 * 512 * 9 + 20 * 513
    per_bin = {"rhs": 8, "mag": 4}[form]
    ops, nbytes = sbound.spectra(rows, 19, 842, 513, form)
    assert ops == rows * 19 * 34142
    assert nbytes == rows * 19 * (4 * 842 + per_bin * 513)
    t, by = bounds.least_time(ops, nbytes, bounds.peak(H100, "f32_flops"),
                              bounds.peak(H100, "hbm_bytes"))
    assert by == "bytes"
    assert launches * t * 1e6 == pytest.approx(us, rel=2e-3)
    assert launches * nbytes / 1e6 == pytest.approx(mb, rel=2e-3)


# ------------------------------------------------------------ the card

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")


# the f32 spectra against the product, over the spectrum's largest
# magnitude: twice the product's own error against a float64 rFFT (1.5e-6
# on the H100); the kernel's FFT is the more exact of the two
F32_TOL = 3e-6
# the kernel against a float64 rFFT: no less exact than the product
F64_TOL = 1.5e-6


def _rel_max(got, want, scale):
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(got, want)) / scale


def _card(B, seed):
    cfg = BiEARConfig(fb_w_dtype="bfloat16")
    c, fL, fR = _frames(cfg, B, seed, "cuda")
    with torch.no_grad():
        plain = [sp.dft_plain(f, c["dft_re"], c["dft_im"]) for f in (fL, fR)]
    scale = max(float(p[0].max()) for p in plain)
    return cfg, c, fL, fR, plain, scale


@pytest.mark.cuda
@pytest.mark.parametrize("B", [512, 64])
def test_the_f32_forms_against_the_product_and_a_float64_rfft(B):
    _need_card()
    cfg, c, fL, fR, plain, scale = _card(B, seed=B)
    for f, p in zip((fL, fR), plain):
        got = sp.spectra_cuda(f, c, cfg.n_fft)
        assert all(x.shape == (B, 19, 513) and x.dtype == torch.float32
                   and x.is_contiguous() for x in got)
        assert _rel_max(got, p, scale) <= F32_TOL
        X = torch.fft.rfft(f.double() * c["window"].double(), n=cfg.n_fft)
        assert _rel_max(got, (X.abs(), X.real, X.imag), scale) <= F64_TOL
        # AuralNet's form: the magnitudes alone, the same bits
        mag, no_re, no_im = sp.spectra_cuda(f, c, cfg.n_fft, mag_only=True)
        assert no_re is None and no_im is None and torch.equal(mag, got[0])


@pytest.mark.cuda
def test_a_tf32_product_fails_the_f32_check(monkeypatch):
    """The control: the DFT as a TF32 product (about 1e-4 of the maximum
    in the probe) is what F32_TOL has to catch."""
    _need_card()
    cfg, c, fL, _, plain, scale = _card(64, seed=5)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    re, im = fL @ c["dft_re"], fL @ c["dft_im"]
    tf32 = (torch.sqrt(re * re + im * im), re, im)
    assert _rel_max(tf32, plain[0], scale) > 10 * F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B", [512, 64])
def test_the_bf16_operand_of_both_ears(B):
    """rhs_cuda is the bf16 rounding (to nearest even) of the kernel's own
    f32 spectra, in rhs_plain's shape and strides. Against the product's
    stack an element differs only where the two f32 values round to
    different bf16 numbers: by the f32 values' difference, at most F32_TOL
    of the maximum (which can be many steps of a value near 0), plus both
    roundings, half a bf16 step each (together at most 2^-7 of the
    product's value, taken before its own rounding); and for at most 1 %
    of the elements."""
    _need_card()
    cfg, c, fL, fR, plain, scale = _card(B, seed=B + 1)
    rhs = sp.rhs_cuda(fL, fR, c, cfg.n_fft)
    own = [sp.spectra_cuda(f, c, cfg.n_fft) for f in (fL, fR)]
    want = sp.rhs_plain(*plain, True)
    assert rhs.shape == want.shape == (19, 2 * B, 4, 513)
    assert rhs.dtype == torch.bfloat16 and rhs.stride() == want.stride()
    assert torch.equal(rhs, sp.rhs_plain(*own, True))
    diff = (rhs.float() - want.float()).abs()
    allowed = want.float().abs() * (2.0 ** -7 + 2.0 ** -14) \
        + F32_TOL * scale
    assert bool((diff <= allowed).all())
    assert float((diff > 0).float().mean()) <= 0.01


@pytest.mark.cuda
def test_a_stream_hop_is_the_forwards_frame_row():
    """A hop (B, win) at its offset in the waveform gives the bits of its
    frame row of the whole waveform's launch (T = 19), in both forms."""
    _need_card()
    cfg, c, fL, fR, _, _ = _card(64, seed=6)
    hop = lambda f: f[:, 7]                     # a (64, 842) strided view
    rhs = sp.rhs_cuda(fL, fR, c, cfg.n_fft)
    got = sp.rhs_cuda(hop(fL), hop(fR), c, cfg.n_fft)
    assert got.shape == (128, 4, 513) and torch.equal(got, rhs[7])
    xs = sp.spectra_cuda(fL, c, cfg.n_fft)
    assert all(torch.equal(a, b[:, 7]) for a, b in
               zip(sp.spectra_cuda(hop(fL), c, cfg.n_fft), xs))


@pytest.mark.cuda
def test_two_launches_and_graph_replays_give_the_same_bits():
    _need_card()
    from biear_tpu_torch.kernels import count_replay, recording_launches

    cfg, c, fL, fR, _, _ = _card(512, seed=7)
    run = lambda: [sp.rhs_cuda(fL, fR, c, cfg.n_fft),
                   *sp.spectra_cuda(fL, c, cfg.n_fft)]
    first, again = run(), run()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with recording_launches() as rec, torch.cuda.graph(graph):
        out = run()
    assert rec["spectra"] == 2
    LAUNCHES.clear()
    for _ in range(2):
        for x in out:
            x.zero_()
        graph.replay()
        count_replay(rec)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, out))
    assert LAUNCHES["spectra"] == 4


@pytest.mark.cuda
def test_each_spectra_call_is_one_launch_with_its_shape():
    _need_card()
    cfg, c, fL, fR, _, _ = _card(64, seed=8)
    LAUNCHES.clear()
    sp.LAUNCH_SHAPES.clear()
    sp.rhs_cuda(fL, fR, c, cfg.n_fft)
    sp.rhs_cuda(fL[:, 0], fR[:, 0], c, cfg.n_fft)
    sp.spectra_cuda(fL, c, cfg.n_fft)
    sp.spectra_cuda(fL, c, cfg.n_fft, mag_only=True)
    torch.cuda.synchronize()
    assert LAUNCHES["spectra"] == 4
    assert dict(sp.LAUNCH_SHAPES) == {(128, 19, 842, 513, "rhs"): 1,
                                      (128, 1, 842, 513, "rhs"): 1,
                                      (64, 19, 842, 513, "xs"): 1,
                                      (64, 19, 842, 513, "mag"): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("family,dtype,launches", [
    ("dual", "bfloat16", 1), ("single", "bfloat16", 1),
    ("auralnet", "bfloat16", 2), ("fixed-q", "bfloat16", 2),
    ("dual", "float32", 0), ("auralnet", "float32", 0)])
def test_a_forward_launches_it_under_the_bf16_policy(family, dtype,
                                                     launches):
    _need_card()
    from biear_tpu_torch.models import build_active, build_auralnet
    from biear_tpu_torch.ops.xcorr import cross_correlation_feature
    from biear_tpu_torch.serve.profile_serve import AURALNET, GEOMETRY

    if family == "auralnet":
        model = build_auralnet(BiEARConfig(**AURALNET, fb_w_dtype=dtype))
    else:
        geometry = GEOMETRY["dual" if family == "fixed-q" else family]
        model = build_active(BiEARConfig(**geometry, fb_w_dtype=dtype,
                                         fixed_frontend_q=family == "fixed-q"))
    wavL, wavR = _wav(8, seed=9, device="cuda")
    with torch.inference_mode():
        x3 = cross_correlation_feature(wavL, wavR, 16000)
        LAUNCHES.clear()
        out = model(wavL, wavR, x3)
        torch.cuda.synchronize()
    assert all(bool(torch.isfinite(o).all()) for o in out[:3])
    assert LAUNCHES["spectra"] == launches
