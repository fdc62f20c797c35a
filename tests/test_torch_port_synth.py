"""The PyTorch port's synthesis path held against the JAX package (CPU).

The window gathers and the HRIR mix take their plain versions here (CPU
tensors); the JAX side runs its Pallas kernels in interpret mode, or its
XLA compositions, as the JAX package's own tests do. Tolerances are
those tests' (tests/test_window_gather.py, tests/test_data.py): the
window gather and the bank bit-exact, the mix at 5e-4 against the numpy
oracle and 5e-5 against ``_gather_mix_xla``, the synthesised waveform at
2e-5 (f32 policy) and 1e-4 (bf16 policy), the labels bit-exact. Scene
draws are injected into both sides; the port's own draws are checked on
their distribution only.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from biear_tpu.data import synth as jsy
from biear_tpu.ops import window_gather as jwg

from biear_tpu_torch.data import labels as tlab
from biear_tpu_torch.data import synth as tsy
from biear_tpu_torch.kernels import LAUNCHES
from biear_tpu_torch.ops import window_gather as twg
from biear_tpu_torch.ops.xcorr import cross_correlation_feature

WIN = 16384


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _pool(seed, np_rows=3, t=17000, left_pad=383, max_off=1200):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((np_rows, t)).astype(np.float32)
    return pool, jwg.pad_pool_for_windows(pool, left_pad, max_off)


def _mix_setup(seed, m_kernels=4, ncol=384):
    """The inputs of tests/test_window_gather.py::_mix_setup."""
    pool, pool3 = _pool(seed)
    rng = np.random.default_rng(seed + 100)
    kb = rng.standard_normal((m_kernels, ncol, 256)).astype(np.float32)
    n = 5
    rows = rng.integers(0, pool.shape[0], size=n).astype(np.int32)
    offs = rng.integers(0, 1200 + 383, size=n).astype(np.int32)
    meas = rng.integers(0, m_kernels, size=n).astype(np.int32)
    return pool3, kb, rows, offs, meas


def _mix_oracle(pool3, rows, offs, meas, kb, nf):
    flat = pool3.reshape(pool3.shape[0], -1)
    out = np.zeros((len(rows), nf, kb.shape[2]))
    for x, (r, o) in enumerate(zip(rows, offs)):
        win = flat[r, o:o + WIN].astype(np.float64)
        fw = np.stack([win[128 * f:128 * f + kb.shape[1]] for f in range(nf)])
        out[x] = fw @ kb[meas[x]].astype(np.float64)
    return out


# ---------------- window gather ----------------

def test_pad_pool_matches_jax():
    pool = np.random.default_rng(0).standard_normal((4, 16000)).astype("f4")
    for lp, mo in ((255, 255), (383, 1200), (0, 0)):
        np.testing.assert_array_equal(twg.pad_pool_for_windows(pool, lp, mo),
                                      jwg.pad_pool_for_windows(pool, lp, mo))


@pytest.mark.parametrize("offs", [[0, 128, 1200], [1, 127, 129],
                                  [640 + 37, 5, 1582]])
def test_gather_windows_matches_jax_kernel_bit_exact(offs):
    pool, pool3 = _pool(0)
    offs = np.asarray(offs, np.int32)
    rows = np.arange(len(offs), dtype=np.int32) % pool.shape[0]
    want = np.asarray(jwg._gather_windows_pallas(
        jnp.asarray(pool3), jnp.asarray(rows), jnp.asarray(offs), True))
    LAUNCHES.clear()
    got = twg.gather_windows(_t(pool3), _t(rows), _t(offs)).numpy()
    assert LAUNCHES["gather_windows"] == 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jwg.gather_windows(
        jnp.asarray(pool3), jnp.asarray(rows), jnp.asarray(offs))))


def test_gather_windows_clamps_like_dynamic_slice():
    _, pool3 = _pool(1)
    rows = np.array([0, 2, 1], np.int32)
    offs = np.array([0, 10 ** 6, 17], np.int32)     # too far: the last window
    want = np.asarray(jwg._gather_windows_xla(
        jnp.asarray(pool3), jnp.asarray(rows), jnp.asarray(offs)))
    got = twg.gather_windows(_t(pool3), _t(rows), _t(offs)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [7, 8])
def test_gather_mix_kb_matches_jax(seed):
    nf = 13
    pool3, kb, rows, offs, meas = _mix_setup(seed)
    args_j = [jnp.asarray(a) for a in (pool3, rows, offs, meas, kb)]
    kern = np.asarray(jwg._gather_mix_pallas(*args_j, nf, True))
    xla = np.asarray(jwg._gather_mix_xla(*args_j, nf))
    LAUNCHES.clear()
    got = twg.gather_mix_kb(*(_t(a) for a in (pool3, rows, offs, meas, kb)),
                            nf).numpy()
    assert LAUNCHES["gather_mix_kb"] == 0
    assert got.shape == kern.shape == (5, nf, 256)
    np.testing.assert_allclose(got, _mix_oracle(pool3, rows, offs, meas, kb,
                                                nf), rtol=0, atol=5e-4)
    np.testing.assert_allclose(got, xla, rtol=0, atol=5e-5)
    np.testing.assert_allclose(got, kern, rtol=0, atol=5e-5)


def test_gather_mix_kb_bf16_bank_matches_jax():
    """The production operand policy: window and bank in bf16, f32 sums."""
    nf = 61
    pool3, kb, rows, offs, meas = _mix_setup(9)
    kb16 = jnp.asarray(kb).astype(jnp.bfloat16)
    want = np.asarray(jwg._gather_mix_xla(
        *(jnp.asarray(a) for a in (pool3, rows, offs, meas)), kb16, nf))
    kbt = _t(kb).to(torch.bfloat16)
    np.testing.assert_array_equal(kbt.float().numpy(),
                                  np.asarray(kb16.astype(jnp.float32)))
    got = twg.gather_mix_kb(*(_t(a) for a in (pool3, rows, offs, meas)),
                            kbt, nf).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_gather_mix_kb_contract_errors():
    pool3, kb, rows, offs, meas = _mix_setup(9)
    args = [_t(a) for a in (pool3, rows, offs, meas)]
    with pytest.raises(ValueError, match="128-padded"):
        twg.gather_mix_kb(*args, _t(kb[:, :383]), 13)
    with pytest.raises(ValueError, match="window coverage"):
        twg.gather_mix_kb(*args, _t(kb), 127)
    with pytest.raises(ValueError, match="window coverage"):
        jwg.gather_mix_kb(*(jnp.asarray(a) for a in (pool3, rows, offs, meas,
                                                     kb)), 127)
    twg.gather_mix_kb(*args, _t(kb), 126)              # the last one that fits


# ---------------- synthesizer bank and fixtures ----------------

def test_fixtures_and_labels_are_copies():
    for a, b in zip(tsy.make_test_hrir_bank(), jsy.make_test_hrir_bank()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsy.make_test_segments(5),
                                  jsy.make_test_segments(5))
    from biear_tpu.data import labels as jlab
    np.testing.assert_array_equal(tlab.DIST_CLASSES, jlab.DIST_CLASSES)
    assert (tlab.N_SECTORS, tlab.N_DIST_CLASSES) == (jlab.N_SECTORS,
                                                     jlab.N_DIST_CLASSES)


@pytest.fixture(scope="module")
def fixture_bank():
    ir, az, dist = tsy.make_test_hrir_bank()
    return ir, az, dist, tsy.make_test_segments(8)


@pytest.mark.parametrize("mix_dtype", ["float32", "bfloat16"])
def test_synth_bank_matches_jax_bit_exact(fixture_bank, mix_dtype):
    ir, az, dist, segs = fixture_bank
    js = jsy.AnechoicSynthesizer(ir, az, dist, segs, mix_dtype=mix_dtype)
    ts = tsy.AnechoicSynthesizer(ir, az, dist, segs, mix_dtype=mix_dtype,
                                 device="cpu")
    assert js._fast and js._n_q == ts.n_q
    np.testing.assert_array_equal(ts.sector_table.numpy(), js._sector_table)
    np.testing.assert_array_equal(ts.sector_counts.numpy(),
                                  js._sector_counts)
    for k in ("segments", "meas_norm", "meas_dcls", "pool3", "KB"):
        want = js._bank[k]
        got = ts.bank[k]
        assert str(got.dtype).split(".")[-1] == str(want.dtype), k
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)),
                                      err_msg=k)


def test_long_segments_take_several_block_offsets(fixture_bank):
    ir, az, dist, _ = fixture_bank
    segs = tsy.make_test_segments(3, seg_len=16000 + 300)
    js = jsy.AnechoicSynthesizer(ir, az, dist, segs)
    ts = tsy.AnechoicSynthesizer(ir, az, dist, segs, device="cpu")
    assert ts.n_q == js._n_q == 3
    np.testing.assert_array_equal(ts.bank["pool3"].numpy(),
                                  np.asarray(js._bank["pool3"]))


# the geometries off the fast path: (segment length, HRIR taps, fs)
GENERAL = {"long-segments": (19200, 256, 16000),
           "2048-taps": (16000, 2048, 16000),
           "sample-offsets": (1700, 256, 1600)}


@pytest.mark.parametrize("case", sorted(GENERAL))
def test_per_sample_geometries_are_not_ported(fixture_bank, case):
    """Formerly refused, these geometries now take the general mix, the
    batched rFFT product: a 1.2 s pool (26 block offsets), a 2,048-tap
    bank and fs = 1600 (sample offsets). With injected draws the waveforms
    match the numpy convolution oracle to 2e-5 and the labels JAX's bit
    for bit; no kernel launches."""
    seg_len, L, fs = GENERAL[case]
    ir, az, dist, _ = fixture_bank
    if L > ir.shape[2]:
        rng = np.random.default_rng(2)
        ir = np.concatenate([ir, 0.01 * rng.standard_normal(
            (ir.shape[0], 2, L - ir.shape[2])).astype(np.float32)], axis=2)
    segs = tsy.make_test_segments(3, seg_len=seg_len)
    ts = tsy.AnechoicSynthesizer(ir, az, dist, segs, fs=fs, device="cpu")
    js = jsy.AnechoicSynthesizer(ir, az, dist, segs, fs=fs)
    assert not ts.fast and not js._fast
    step = 128 if fs % 128 == 0 else 1
    assert ts.off_step == step
    assert ts.n_q == (seg_len - fs) // step + 1
    if case == "long-segments":
        assert ts.n_q == 26
    rng = np.random.default_rng(5)
    B = 4
    active, meas, seg_idx, _, crop = _scene(rng, B, ir.shape[0], len(segs),
                                            L)
    qoff = rng.integers(0, ts.n_q, (B, 3))
    qoff[0, 0] = ts.n_q - 1                       # the last offset
    sectors = np.stack([rng.permutation(8)[:3] for _ in range(B)])
    LAUNCHES.clear()
    got = ts.mix_general(*(_t(a) for a in (active, meas, seg_idx, qoff,
                                           crop))).numpy()
    assert sum(LAUNCHES.values()) == 0 and got.shape == (B, 2, fs)
    np.testing.assert_allclose(
        got, _conv_oracle(segs, ir, active, meas, seg_idx, crop, fs,
                          qoff * step), rtol=0, atol=2e-5)
    yj = np.asarray(js._labels_batched(
        js._bank, *(jnp.asarray(a) for a in (active, sectors, meas))))
    yt = ts.labels_batched(*(_t(a) for a in (active, sectors, meas))).numpy()
    np.testing.assert_array_equal(yt, yj)
    wl, wr, x3, y = ts.sample_batch(torch.Generator().manual_seed(1), 3)
    assert wl.shape == (3, fs) and x3.shape == (3, 100) and y.shape == (3, 56)
    peak = torch.maximum(wl.abs().amax(1), wr.abs().amax(1))
    torch.testing.assert_close(peak, torch.ones(3), rtol=0, atol=1e-6)


# ---------------- mix and labels with injected scene draws ----------------

def _scene(rng, B, M, n_segs, L):
    meas = rng.integers(0, M, (B, 3))
    seg_idx = rng.integers(0, n_segs, (B, 3))
    qoff = np.zeros((B, 3), np.int64)
    crop = rng.integers(0, L, (B, 3))
    active = np.zeros((B, 3), bool)
    for b in range(B):
        active[b, :b % 3 + 1] = True
    return active, meas, seg_idx, qoff, crop


def _conv_oracle(segs, ir, active, meas, seg_idx, crop, fs=16000,
                 start=None):
    """Per sample and source: the segment's fs samples from `start`
    (0 by default), full convolution with the HRIR pair, the crop, the
    source sum and the joint peak normalisation, in float64."""
    B = active.shape[0]
    start = np.zeros(active.shape, np.int64) if start is None else start
    want = np.zeros((B, 2, fs))
    for b in range(B):
        mix = np.zeros((2, fs))
        for s in range(3):
            if not active[b, s]:
                continue
            o = start[b, s]
            seg = segs[seg_idx[b, s], o:o + fs].astype(np.float64)
            for e in range(2):
                full = np.convolve(seg, ir[meas[b, s], e].astype(np.float64))
                mix[e] += full[crop[b, s]:crop[b, s] + fs]
        want[b] = mix / max(np.abs(mix).max(), 1e-8)
    return want


@pytest.mark.parametrize("mix_dtype,tol", [("float32", 2e-5),
                                           ("bfloat16", 1e-4)])
def test_mix_and_labels_match_jax(fixture_bank, mix_dtype, tol):
    ir, az, dist, segs = fixture_bank
    js = jsy.AnechoicSynthesizer(ir, az, dist, segs, mix_dtype=mix_dtype)
    ts = tsy.AnechoicSynthesizer(ir, az, dist, segs, mix_dtype=mix_dtype,
                                 device="cpu")
    rng = np.random.default_rng(7)
    B = 4
    active, meas, seg_idx, qoff, crop = _scene(rng, B, ir.shape[0],
                                               len(segs), ir.shape[2])
    sectors = np.stack([rng.permutation(8)[:3] for _ in range(B)])
    want = np.asarray(js._mix_fast(
        js._bank, *(jnp.asarray(a) for a in (active, meas, seg_idx, qoff,
                                             crop)), B))
    LAUNCHES.clear()
    got = ts.mix_fast(*(_t(a) for a in (active, meas, seg_idx, qoff,
                                        crop))).numpy()
    assert sum(LAUNCHES.values()) == 0
    assert got.shape == (B, 2, 16000)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if mix_dtype == "float32":
        np.testing.assert_allclose(got, _conv_oracle(segs, ir, active, meas,
                                                     seg_idx, crop),
                                   rtol=0, atol=tol)
    yj = np.asarray(js._labels_batched(
        js._bank, *(jnp.asarray(a) for a in (active, sectors, meas))))
    yt = ts.labels_batched(*(_t(a) for a in (active, sectors, meas))).numpy()
    assert yt.shape == (B, 56)
    np.testing.assert_array_equal(yt, yj)


# ---------------- the port's own draws ----------------

def test_scene_draws_have_the_reference_distribution(fixture_bank):
    ir, az, dist, segs = fixture_bank
    ts = tsy.AnechoicSynthesizer(ir, az, dist, segs, device="cpu")
    gen = torch.Generator().manual_seed(0)
    active, sectors, meas, seg_idx, qoff, crop = ts.scene_batched(gen, 600)
    n_src = active.sum(1).numpy()
    assert set(n_src.tolist()) == {1, 2, 3}
    assert abs((n_src == 1).mean() - 1 / 3) < 0.07
    s = sectors.numpy()
    assert all(len(set(row)) == 3 for row in s)
    assert set(s.reshape(-1).tolist()) == set(range(8))
    meas_sector = (np.floor((az % 360) / 45.0).astype(int))[meas.numpy()]
    np.testing.assert_array_equal(meas_sector, s)
    assert set(meas.numpy().reshape(-1).tolist()) == set(range(len(az)))
    assert seg_idx.max() < len(segs) and int(qoff.max()) == 0
    assert 0 <= int(crop.min()) and int(crop.max()) < ir.shape[2]
    forced = ts.scene_batched(gen, 50, n_src_fixed=2)[0]
    assert bool((forced.sum(1) == 2).all())


def test_sample_batch_is_consistent(fixture_bank):
    ir, az, dist, segs = fixture_bank
    ts = tsy.AnechoicSynthesizer(ir, az, dist, segs, mix_dtype="bfloat16",
                                 device="cpu")
    wl, wr, x3, y = ts.sample_batch(torch.Generator().manual_seed(4), 3)
    assert wl.shape == wr.shape == (3, 16000) and x3.shape == (3, 100)
    assert y.shape == (3, 56)
    peak = torch.maximum(wl.abs().amax(1), wr.abs().amax(1))
    torch.testing.assert_close(peak, torch.ones(3), rtol=0, atol=1e-6)
    torch.testing.assert_close(x3, cross_correlation_feature(wl, wr, 16000),
                               rtol=0, atol=0)
    yy = y.reshape(3, 8, 7)
    assert bool((yy[:, :, 2:].sum(-1) == 1).all())
    assert bool(((yy[:, :, 0] == 1) == (yy[:, :, 2] == 0)).all())
    again = ts.sample_batch(torch.Generator().manual_seed(4), 3)
    for a, b in zip((wl, wr, x3, y), again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_diffuse_noise_snr_and_label_invariance(fixture_bank):
    """The SNR check of tests/test_data.py, and labels untouched."""
    ir, az, dist, segs = fixture_bank
    clean = tsy.AnechoicSynthesizer(ir, az, dist, segs, device="cpu")
    noisy = tsy.AnechoicSynthesizer(ir, az, dist, segs, device="cpu",
                                    noise_snr_db=(10.0, 12.0))
    bc = clean.sample_batch(torch.Generator().manual_seed(7), 16)
    bn = noisy.sample_batch(torch.Generator().manual_seed(7), 16)
    torch.testing.assert_close(bc[3], bn[3], rtol=0, atol=0)
    assert not torch.allclose(bc[0], bn[0])
    assert float(bn[0].abs().max()) <= 1.0 + 1e-6
    y = torch.stack([bc[0], bc[1]], dim=1).double()
    yn = tsy.add_diffuse_noise(torch.Generator().manual_seed(3), y,
                               (20.0, 20.0))
    scale = ((yn * y).sum((1, 2)) / (yn * yn).sum((1, 2)))[:, None, None]
    n_hat = yn * scale - y
    snr = 10 * torch.log10((y * y).sum((1, 2)) / (n_hat * n_hat).sum((1, 2)))
    assert float(snr.min()) > 16.0 and float(snr.max()) < 24.0
