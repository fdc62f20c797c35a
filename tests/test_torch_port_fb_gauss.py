"""The adaptive filterbank's bf16 forward contract on the CPU.

``ops.filterbank.gauss_contract`` is the one path of the bf16 forward:
``kernels/fb_gauss.cu`` for a CUDA tensor, ``gauss_contract_plain`` (the
plain ops) for a CPU tensor. Here the plain path is held bit for bit to
the ops the three bf16 callers ran before it (``FilterbankFn`` in "bf16"
and "bf16|noxg", ``fb_forward`` without a gradient), outputs and saved
tensors, at small odd sizes; a strided frame of the frontend's stack
gives the bits of a contiguous copy; a NaN or infinite Q gives the plain
ops' Y and finite mask; the kernel's wrapper refuses CPU tensors and bad
shapes before it reaches the library. The kernel itself is held on the
card by ``tests/test_torch_port_package.py`` (marked ``cuda``).
"""

import numpy as np
import pytest
import torch

from biear_tpu_torch.kernels import LAUNCHES
from biear_tpu_torch.kernels import build
from biear_tpu_torch.ops import filterbank as fb

R, N, F = 3, 7, 33


def _inputs(seed=0, R=R, N=N, F=F):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    fc = t(np.sort(rng.uniform(50.0, 700.0, N)))
    f_fft = t(np.linspace(0.0, 800.0, F))
    Q = t(rng.uniform(0.5, 9.0, (R, N)))
    spec = [t(np.abs(rng.standard_normal((R, F)))),
            t(rng.standard_normal((R, F))), t(rng.standard_normal((R, F)))]
    return Q, fb.stack_rhs(*spec, bf16=True), fc, f_fft


def _before(Q, rhs, fc, f_fft, with_t):
    """The bf16 forward as FilterbankFn and fb_forward computed it before
    the contract: (Y, Zre, Zim, den, finite, bw, T)."""
    bw, t, G = fb._gauss_fast(Q, fc, f_fft)
    out = fb._dot(G, rhs, True, "bnf,bcf->bnc")
    T = fb._dot(G * (-2.0 * t), rhs, True, "bnf,bcf->bnc") if with_t else None
    return (*fb._normalise(out), bw[..., 0], T)


def _same(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())


@pytest.mark.parametrize("caller", ["bf16|noxg", "bf16", "fb_forward"])
def test_plain_contract_is_the_callers_former_ops(caller):
    Q, rhs, fc, f_fft = _inputs(1)
    with_t = caller == "bf16|noxg"
    want = _before(Q, rhs, fc, f_fft, with_t)
    got = fb.gauss_contract(Q, rhs, fc, f_fft, with_t)
    for a, b in zip(got, want):
        _same(a, b)
    Y, Zre, Zim, den, finite, bw, T = want
    if caller == "fb_forward":
        for a, b in zip(fb.fb_forward(Q, fc, f_fft, rhs, True), want[:3]):
            _same(a, b)
        return
    q = Q.clone().requires_grad_()
    out = fb.FilterbankFn.apply(q, rhs, fc, f_fft, caller)
    for a, b in zip(out, want[:3]):
        _same(a, b)
    saved = out[0].grad_fn.saved_tensors
    if with_t:
        expect = (Q, fc, bw, T, Y, Zre, Zim, den, finite)
    else:
        expect = (Q, fc, f_fft, rhs, Y, Zre, Zim, den, finite)
    assert len(saved) == len(expect)
    for a, b in zip(saved, expect):
        _same(a.float(), b.float())


def test_fb_forward_under_autograd_stays_plain(monkeypatch):
    """With a gradient to take, fb_forward is plain autograd (the
    "autodiff" VJP): it never calls the contract."""
    Q, rhs, fc, f_fft = _inputs(2)
    calls = []
    monkeypatch.setattr(fb, "gauss_contract",
                        lambda *a: calls.append(a) or None)
    q = Q.clone().requires_grad_()
    Y = fb.fb_forward(q, fc, f_fft, rhs, True)[0]
    assert calls == [] and Y.requires_grad
    _same(Y, _before(Q, rhs, fc, f_fft, False)[0])


def test_a_strided_frame_gives_the_bits_of_a_copy():
    """rhs[t] of the frontend's (T, 2B, 4, F) view (row stride T 4 F) and
    its contiguous copy give the same outputs."""
    T_frames = 5
    rng = np.random.default_rng(3)
    stack = torch.tensor(rng.standard_normal((R, T_frames, 4, F)),
                         dtype=torch.float32).to(torch.bfloat16)
    view = stack.transpose(0, 1)
    Q, _, fc, f_fft = _inputs(3)
    for t in (0, 3):
        assert not view[t].is_contiguous()
        got = fb.gauss_contract(Q, view[t], fc, f_fft, True)
        want = fb.gauss_contract(Q, view[t].contiguous(), fc, f_fft, True)
        for a, b in zip(got, want):
            _same(a, b)


def test_nonfinite_q_gives_the_plain_y_and_mask():
    """A NaN Q entry: Y = 0 and finite False there and only there; an
    infinite one: the former ops' bits (a 1e-8 bandwidth); Y is finite
    everywhere."""
    Q, rhs, fc, f_fft = _inputs(4)
    Q[1, 2] = float("nan")
    Q[2, 5] = float("inf")
    Q[0, 0] = -float("inf")
    got = fb.gauss_contract(Q, rhs, fc, f_fft, True)
    for a, b in zip(got, _before(Q, rhs, fc, f_fft, True)):
        _same(a, b)
    Y, finite = got[0], got[4]
    assert float(Y[1, 2]) == 0.0 and not bool(finite[1, 2])
    mask = torch.ones_like(finite)
    mask[1, 2] = False
    assert bool(finite[mask].all()) and bool(torch.isfinite(Y).all())


def test_the_cuda_entry_refuses_cpu_tensors_before_the_library(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "fb_gauss_lib",
                        lambda: calls.append(1) or None)
    Q, rhs, fc, f_fft = _inputs(5)
    LAUNCHES.clear()
    with pytest.raises(ValueError, match="CUDA"):
        fb.gauss_contract_cuda(Q, rhs, fc, f_fft, True)
    # bad shapes are refused first, whatever the device
    for bad in ((Q[:, :-1], rhs, fc, f_fft), (Q, rhs[:, :3], fc, f_fft),
                (Q, rhs, fc, f_fft[:-1]), (Q[0], rhs, fc, f_fft)):
        with pytest.raises(ValueError, match="fb_gauss needs"):
            fb.gauss_contract_cuda(*bad, False)
    # the CPU callers take the plain path and launch nothing
    fb.gauss_contract(Q, rhs, fc, f_fft, True)
    fb.FilterbankFn.apply(Q.clone().requires_grad_(), rhs, fc, f_fft,
                          "bf16|noxg")
    fb.fb_forward(Q, fc, f_fft, rhs, True)
    assert calls == [] and LAUNCHES["fb_gauss"] == 0
    assert not fb.LAUNCH_SHAPES


@pytest.mark.parametrize("train", [False, True])
def test_every_bf16_frame_of_a_forward_goes_through_the_contract(
        monkeypatch, train):
    """One contract call per frame (both ears at once) in the frontend's
    no-grad forward and in its training forward (FilterbankFn "bf16|noxg",
    with T); none under the f32 policy."""
    from biear_tpu_torch.models import BiEARConfig, build_active

    calls = []
    real = fb.gauss_contract

    def spy(Q, rhs, fc, f_fft, with_t):
        calls.append((tuple(Q.shape), tuple(rhs.shape), with_t))
        return real(Q, rhs, fc, f_fft, with_t)
    monkeypatch.setattr(fb, "gauss_contract", spy)
    torch.manual_seed(0)
    wav = torch.rand((2, 2, 1600)) * 2 - 1
    for dtype in ("bfloat16", "float32"):
        cfg = BiEARConfig(fs=1600, timesteps=3, n_fft=64, n_bands=9,
                          fmin=50.0, fmax=700.0, latent_dim=8,
                          ctrl_hidden=8, fb_w_dtype=dtype, fb_x_grad=False)
        model = build_active(cfg, seed=1, device="cpu")
        calls.clear()
        with torch.set_grad_enabled(train):
            model.bifb(wav[0], wav[1])
        if dtype == "float32":
            assert calls == []
        else:
            assert calls == [((4, 9), (4, 4, 33), train)] * 3
