"""Signal ops of the PyTorch port held against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through each JAX function and
its counterpart in ``biear_tpu_torch``. Tolerances are those of the JAX
package's own tests for the same ops (named per test).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from biear_tpu.models import BiEARConfig as JaxConfig
from biear_tpu.models import frontend as jfe
from biear_tpu.ops import erb as jerb
from biear_tpu.ops import filterbank as jfb
from biear_tpu.ops import framing as jfr
from biear_tpu.ops import window_gather as jwg
from biear_tpu.ops import xcorr as jxc

from biear_tpu_torch.kernels import LAUNCHES
from biear_tpu_torch.models.config import BiEARConfig
from biear_tpu_torch.models import frontend as tfe
from biear_tpu_torch.ops import erb as terb
from biear_tpu_torch.ops import filterbank as tfb
from biear_tpu_torch.ops import framing as tfr
from biear_tpu_torch.ops import window_gather as twg
from biear_tpu_torch.ops import xcorr as txc


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------- ERB grid, framing ----------------

@pytest.mark.parametrize("N,fmin,fmax,dq", [
    (100, 50.0, 7200.0, (1.0, 0.3, 5.0)),
    (100, 50.0, 7200.0, (2.0, 0.5, 1.0)),
    (24, 80.0, 4000.0, (1.5, 0.2, 3.0)),
])
def test_erb_constants_exact(N, fmin, fmax, dq):
    fc_j, q0_j = jerb.erb_spaced_fc_and_q(N, fmin, fmax)
    fc_t, q0_t = terb.erb_spaced_fc_and_q(N, fmin, fmax)
    np.testing.assert_array_equal(fc_t, fc_j)
    np.testing.assert_array_equal(q0_t, q0_j)
    np.testing.assert_array_equal(terb.make_deltaQ_profile(fc_t, *dq),
                                  jerb.make_deltaQ_profile(fc_j, *dq))


@pytest.mark.parametrize("nsamp,fs,timesteps,hop_ratio", [
    (16000, 16000, 19, 1.0),     # exact length
    (17000, 16000, 19, 1.0),     # crop
    (9000, 16000, 19, 0.5),      # pad, overlapping hops
    (500, 800, 1, 1.0),          # short input padded to fs
    (1000, 600, 2, 2.0),         # frame axis padded up to T
])
def test_frame_1s_exact(nsamp, fs, timesteps, hop_ratio):
    win, hop = tfr.frame_params(fs, timesteps, hop_ratio)
    assert (win, hop) == jfr.frame_params(fs, timesteps, hop_ratio)
    np.testing.assert_array_equal(tfr.hann_window_periodic(win),
                                  jfr.hann_window_periodic(win))
    wav = np.random.default_rng(1).standard_normal((2, nsamp)).astype(np.float32)
    got = tfr.frame_1s(_t(wav), fs, timesteps, win, hop).numpy()
    want = np.asarray(jfr.frame_1s(jnp.asarray(wav), fs, timesteps, win, hop))
    assert got.shape == want.shape == (2, timesteps, win)
    np.testing.assert_array_equal(got, want)


def test_frame_1s_pads_short_fs_to_win():
    """fs < win: the waveform is zero-padded up to one window."""
    wav = np.arange(2 * 300, dtype=np.float32).reshape(2, 300)
    got = tfr.frame_1s(_t(wav), 300, 1, 400, 400).numpy()
    want = np.asarray(jfr.frame_1s(jnp.asarray(wav), 300, 1, 400, 400))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dft_mode", ["fft", "matmul"])
def test_spectra_matches_jax(dft_mode):
    """Both DFT modes at atol 1e-4 of the spectrum maximum."""
    kw = dict(n_bands=100, dft_mode=dft_mode)
    cfg_t, cfg_j = BiEARConfig(**kw), JaxConfig(**kw)
    wav = np.random.default_rng(2).uniform(-1, 1, (2, 16000)).astype(np.float32)
    c = tfe.device_constants(cfg_t, "cpu")
    got = tfe.spectra(cfg_t, _t(wav), c)
    want = jfe.spectra(cfg_j, jnp.asarray(wav))
    scale = float(np.max(np.asarray(want[0])))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4 * scale)


def test_frontend_constants_match_jax():
    cfg_t = BiEARConfig(deltaQ_mode="relative", deltaQ_base=1.0,
                        deltaQ_low_factor=0.3, deltaQ_high_factor=5.0)
    cfg_j = JaxConfig(deltaQ_mode="relative", deltaQ_base=1.0,
                      deltaQ_low_factor=0.3, deltaQ_high_factor=5.0)
    ct, cj = tfe.frontend_constants(cfg_t), jfe.frontend_constants(cfg_j)
    assert ct.keys() == cj.keys()
    for k in ct:
        np.testing.assert_array_equal(np.asarray(ct[k]), np.asarray(cj[k]),
                                      err_msg=k)


# ---------------- filterbank forward ----------------

@pytest.mark.parametrize("bf16,tol", [(False, 5e-5), (True, 2e-2)])
def test_filterbank_forward_matches_jax(bf16, tol):
    """Divide-after forward, f32 at 5e-5 and bf16 at 2e-2
    (tests/test_ops.py::test_filterbank_apply_custom_vjp_parity)."""
    rng = np.random.default_rng(3)
    fc, Q0 = terb.erb_spaced_fc_and_q(100, 50.0, 7200.0)
    f_fft = np.linspace(0, 8000.0, 513).astype(np.float32)
    Q = (Q0[None] * rng.uniform(0.7, 1.4, (3, 100))).astype(np.float32)
    X = rng.standard_normal((3, 513)) + 1j * rng.standard_normal((3, 513))
    spec = [np.abs(X).astype(np.float32), X.real.astype(np.float32),
            X.imag.astype(np.float32)]
    wd = jnp.bfloat16 if bf16 else None
    want = jfb.filterbank_apply_ref(jnp.asarray(Q), jnp.asarray(fc),
                                    jnp.asarray(f_fft),
                                    *(jnp.asarray(s) for s in spec),
                                    w_dtype=wd)
    got = tfb.fb_forward(_t(Q), _t(fc), _t(f_fft),
                         tfb.stack_rhs(*(_t(s) for s in spec), bf16), bf16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol * 1e-1)
    np.testing.assert_allclose(tfb.band_phase(got[1], got[2]).numpy(),
                               np.asarray(jfb.band_phase(*want[1:])),
                               rtol=tol, atol=tol * 1e-1)


def test_gauss_builds_match_jax():
    rng = np.random.default_rng(4)
    fc, Q0 = terb.erb_spaced_fc_and_q(64, 50.0, 7200.0)
    f_fft = np.linspace(0, 8000.0, 257).astype(np.float32)
    Q = (Q0[None] * rng.uniform(0.7, 1.4, (2, 64))).astype(np.float32)
    args_j = (jnp.asarray(Q), jnp.asarray(fc), jnp.asarray(f_fft))
    args_t = (_t(Q), _t(fc), _t(f_fft))
    np.testing.assert_allclose(tfb.fb_gauss(*args_t).numpy(),
                               np.asarray(jfb._fb_gauss(*args_j)[2]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tfb.fb_gauss_fast(*args_t).numpy(),
                               np.asarray(jfb._fb_gauss_fast(*args_j)[2]),
                               rtol=1e-6, atol=1e-7)


def test_stack_rhs_layout_and_dtype():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    rhs = tfb.stack_rhs(x, x + 1, x + 2)
    assert rhs.shape == (2, 4, 3) and rhs.dtype == torch.float32
    np.testing.assert_array_equal(rhs[:, 3].numpy(), 1.0)
    assert tfb.stack_rhs(x, x, x, bf16=True).dtype == torch.bfloat16


# ---------------- cross-correlation ----------------

@pytest.mark.parametrize("B,n,mk", [(4, 1280, 48), (3, 2560, 33),
                                    (1, 16000, 48), (5, 1024, 63)])
def test_cc_kept_lags_plain_matches_jax_kernel(B, n, mk):
    """The port's plain version against the Pallas kernel in interpret
    mode, at rtol 2e-5 / atol 2e-4 (tests/test_window_gather.py)."""
    rng = np.random.default_rng(5)
    lf = rng.standard_normal((B, n)).astype(np.float32)
    rf = rng.standard_normal((B, n)).astype(np.float32)
    want = np.asarray(jwg.cc_kept_lags(jnp.asarray(lf), jnp.asarray(rf), mk,
                                       use_kernel=True, interpret=True))
    got = twg.cc_kept_lags(_t(lf), _t(rf), mk).numpy()
    assert got.shape == (B, 2 * mk + 1)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("n", [16000, 4096, 12345, 1000])
def test_cross_correlation_feature_matches_jax(n):
    """Aligned n (lag kernel / plain block product) and unaligned n (FFT)."""
    rng = np.random.default_rng(6)
    left = rng.standard_normal((3, n)).astype(np.float32)
    right = np.roll(left, 7, axis=1) + 0.3 * rng.standard_normal(
        (3, n)).astype(np.float32)
    want = np.asarray(jxc.cross_correlation_feature(
        jnp.asarray(left), jnp.asarray(right), 16000, num_lags=100))
    got = txc.cross_correlation_feature(_t(left), _t(right), 16000,
                                        num_lags=100).numpy()
    assert got.shape == (3, 100)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_cross_correlation_feature_one_dim_and_wide_window():
    """1-D input, and max_kept == 64 (the plain block product branch)."""
    rng = np.random.default_rng(7)
    a, b = (rng.standard_normal(2048).astype(np.float32) for _ in range(2))
    for fs, ms in ((16000, 3.0), (16000, 4.0)):
        want = np.asarray(jxc.cross_correlation_feature(
            jnp.asarray(a), jnp.asarray(b), fs, 50, ms))
        got = txc.cross_correlation_feature(_t(a), _t(b), fs, 50, ms).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_lag_plan_matches_jax():
    for args in ((16000, 16000, 100, 3.0), (12345, 16000, 100, 3.0),
                 (2048, 16000, 50, 4.0)):
        for a, b in zip(txc.lag_plan(*args), jxc._lag_plan(*args)):
            np.testing.assert_array_equal(a, b)


def test_cc_kept_lags_rejects_bad_shapes():
    x = torch.zeros((2, 1280))
    with pytest.raises(ValueError, match="cc kernel"):
        twg.cc_kept_lags(x, x, 64)
    with pytest.raises(ValueError, match="cc kernel"):
        twg.cc_kept_lags(torch.zeros((2, 1000)), torch.zeros((2, 1000)), 8)
    with pytest.raises(ValueError, match="cc kernel"):
        twg.cc_kept_lags(x, torch.zeros((3, 1280)), 8)


def test_cc_kept_lags_on_cpu_takes_the_plain_version(monkeypatch):
    """Dispatch is by device: a CPU tensor never reaches the kernel."""
    def boom(*a, **k):
        raise AssertionError("CUDA kernel called for a CPU tensor")
    monkeypatch.setattr(twg, "cc_kept_lags_cuda", boom)
    LAUNCHES.clear()
    x = torch.randn(2, 1280, generator=torch.Generator().manual_seed(0))
    out = twg.cc_kept_lags(x, x.flip(1), 20)
    np.testing.assert_array_equal(
        out.numpy(), txc.cc_kept_lags_plain(x, x.flip(1), 20).numpy())
    assert LAUNCHES["cc_lags"] == 0

