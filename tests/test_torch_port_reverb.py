"""The port's reverberant scenes held against the JAX package (CPU).

``ReverbSynthesizer`` (auditorium and spirit, the built-in banks of
``make_test_brir_bank``):

  * its tables (sector, in-sector angle and distance one-hot index per
    head and speaker) and its BRIR spectra at fft_len = next_pow2(fs + L -
    1) equal JAX's bit for bit;
  * one batch on the same draws: JAX's ``sample_batch_meta`` returns the
    head, speakers, sectors and active mask of every sample, and a pool of
    one segment of exactly fs samples fixes the segment draw; the port's
    mix of those draws matches JAX's waveforms to 2e-5 (the f32 synthesis
    tolerance of tests/test_torch_port_synth.py), its labels bit for bit
    and its CC feature to the CC's 2e-5 / 2e-4;
  * the port's own draws are checked on their distribution only (torch's
    random streams are not JAX's);
  * ``load_sofa_brir`` / ``extract_head_yaw`` equal the tool's on a SOFA
    file the test writes; ``build_synthesizer`` gives JAX's bank for
    "spirit", "auditorium" and its alias "room".
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax

from biear_tpu.data import synth_reverb as jrv

from biear_tpu_torch.data import synth as tsy
from biear_tpu_torch.data import synth_reverb as trv
from biear_tpu_torch.kernels import LAUNCHES
from biear_tpu_torch.ops.xcorr import cross_correlation_feature

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVE_TOL = 2e-5
SCENES = {"spirit": 3, "auditorium": 6}


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _bank(scene, ir_len=1200):
    sxy = trv.scene_speaker_xy(scene, SCENES[scene])
    return trv.make_test_brir_bank(ir_len=ir_len, speaker_xy=sxy)


def test_fixtures_and_tables_are_copies():
    for scene, E in SCENES.items():
        for a, b in zip(_bank(scene), jrv.make_test_brir_bank(
                speaker_xy=jrv.scene_speaker_xy(scene, E))):
            np.testing.assert_array_equal(a, b)
    for d in (0.2, 0.7, 1.4, 2.6, 3.0, 3.01, 5.49):
        assert trv.dist_class_5(d) == jrv.dist_class_5(d)
    for key in ("auditorium", "room", "spirit"):
        np.testing.assert_array_equal(trv.SCENE_SPEAKER_XY[key],
                                      jrv.SCENE_SPEAKER_XY[key])
    with pytest.raises(ValueError, match="emitters"):
        trv.scene_speaker_xy("spirit", 4)
    with pytest.raises(ValueError, match="unknown room scene"):
        trv.scene_speaker_xy("garden", 3)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_tables_and_brir_spectra_match_jax_bit_exact(scene):
    ir, yaw, sxy = _bank(scene)
    segs = tsy.make_test_segments(2)
    js = jrv.ReverbSynthesizer(ir, yaw, sxy, segs)
    ts = trv.ReverbSynthesizer(ir, yaw, sxy, segs, device="cpu")
    assert ts.fft_len == js._fft_len == 32768
    np.testing.assert_array_equal(ts.sector_table.numpy(), js._sector_np)
    np.testing.assert_array_equal(ts.norm_table.numpy(), js._norm_np)
    np.testing.assert_array_equal(ts.onehot_idx.numpy(), js._onehot_np)
    H = ts.bank["H"]
    assert H.dtype == torch.complex64
    assert H.shape == (len(yaw), SCENES[scene], 2, 16385)
    Hj = np.transpose(np.asarray(js._bank["H_re"]), (0, 2, 1, 3))
    np.testing.assert_array_equal(H.real.numpy(), Hj)
    np.testing.assert_array_equal(H.imag.numpy(), np.transpose(
        np.asarray(js._bank["H_im"]), (0, 2, 1, 3)))
    np.testing.assert_array_equal(ts.bank["segments"].numpy(),
                                  np.asarray(js._bank["segments"]))
    if scene == "auditorium":       # the 3.97 m and 5.49 m speakers
        assert int(ts.onehot_idx.max()) == 4


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_batch_on_jax_draws_matches_jax(scene):
    ir, yaw, sxy = _bank(scene)
    segs = tsy.make_test_segments(1, seed=4)       # one segment of fs
    js = jrv.ReverbSynthesizer(ir, yaw, sxy, segs)
    ts = trv.ReverbSynthesizer(ir, yaw, sxy, segs, device="cpu")
    B = 6
    wl, wr, x3, y, meta = (np.asarray(a) if not isinstance(a, dict) else
                           {k: np.asarray(v) for k, v in a.items()}
                           for a in js.sample_batch_meta(
                               jax.random.PRNGKey(3), B))
    head = _t(meta["head_index"].astype(np.int64))
    speakers = _t(meta["speaker_id"].astype(np.int64))
    sectors = _t(meta["sector_id"].astype(np.int64))
    active = _t(meta["active"] > 0.5)
    zeros = torch.zeros((B, 3), dtype=torch.long)
    LAUNCHES.clear()
    got = ts.mix(head, active, speakers, zeros, zeros).numpy()
    labels = ts.labels_batched(head, active, sectors, speakers).numpy()
    np.testing.assert_allclose(got[:, 0], wl, rtol=0, atol=WAVE_TOL)
    np.testing.assert_allclose(got[:, 1], wr, rtol=0, atol=WAVE_TOL)
    np.testing.assert_array_equal(labels, y)
    peak = np.abs(got).max(axis=(1, 2))
    np.testing.assert_allclose(peak, 0.9, rtol=0, atol=1e-6)
    x3t = cross_correlation_feature(_t(got[:, 0]), _t(got[:, 1]), 16000)
    np.testing.assert_allclose(x3t.numpy(), x3, rtol=2e-5, atol=2e-4)
    assert sum(LAUNCHES.values()) == 0


def test_own_draws_have_the_reference_distribution():
    ir, yaw, sxy = _bank("auditorium")
    ts = trv.ReverbSynthesizer(ir, yaw, sxy, tsy.make_test_segments(3),
                               device="cpu")
    gen = torch.Generator().manual_seed(0)
    B = 500
    head, active, sectors, speakers, seg_idx, qoff = ts.scene_batched(gen, B)
    assert set(head.tolist()) == set(range(len(yaw)))
    n_src = active.sum(1)
    assert set(n_src.tolist()) <= {1, 2, 3} and int(n_src.min()) == 1
    spk_sec = ts.sector_table[head[:, None], speakers]
    for b in range(B):
        n = int(n_src[b])
        s = sectors[b, :n].tolist()
        assert len(set(s)) == n                          # distinct sectors
        assert spk_sec[b, :n].tolist() == s            # speaker in sector
        occupied = set(ts.sector_table[head[b]].tolist())
        assert set(s) <= occupied
        # speakers are distinct where the chosen sectors hold unused ones
        assert len(set(speakers[b, :n].tolist())) == n
    assert int(qoff.max()) == 0 and int(seg_idx.max()) < 3
    forced = ts.scene_batched(gen, 50, n_src_fixed=3)[1]
    assert bool((forced.sum(1) >= 1).all())
    wl, wr, x3, y = ts.sample_batch(torch.Generator().manual_seed(2), 4)
    peak = torch.maximum(wl.abs().amax(1), wr.abs().amax(1))
    torch.testing.assert_close(peak, torch.full((4,), 0.9), rtol=0,
                               atol=1e-6)
    yy = y.reshape(4, 8, 7)
    assert bool((yy[:, :, 2:].sum(-1) == 1).all())
    again = ts.sample_batch(torch.Generator().manual_seed(2), 4)
    for a, b in zip((wl, wr, x3, y), again):
        assert torch.equal(a, b)


def test_long_pool_and_noise():
    """A 1.2 s pool draws 128-sample block offsets, as JAX's per-sample
    path does; with diffuse noise the labels are unchanged."""
    ir, yaw, sxy = _bank("spirit", ir_len=300)
    segs = tsy.make_test_segments(2, seg_len=19200)
    ts = trv.ReverbSynthesizer(ir, yaw, sxy, segs, device="cpu")
    assert (ts.off_step, ts.n_q) == (128, 26)
    assert ts.fft_len == jrv.ReverbSynthesizer(ir, yaw, sxy, segs)._fft_len
    head, active, sectors, speakers, seg_idx, qoff = ts.scene_batched(
        torch.Generator().manual_seed(1), 200)
    assert int(qoff.max()) == 25 and int(qoff.min()) == 0
    noisy = trv.ReverbSynthesizer(ir, yaw, sxy, segs, device="cpu",
                                  noise_snr_db=(10.0, 12.0))
    bc = ts.sample_batch(torch.Generator().manual_seed(5), 4)
    bn = noisy.sample_batch(torch.Generator().manual_seed(5), 4)
    assert torch.equal(bc[3], bn[3]) and not torch.equal(bc[0], bn[0])


def test_sofa_brir_loaders_match_the_tool(tmp_path):
    h5py = pytest.importorskip("h5py")
    sys.path.insert(0, REPO)
    from tools.sofa_io import extract_head_yaw as tool_yaw
    from tools.sofa_io import load_sofa_brir as tool_load
    rng = np.random.default_rng(9)
    M = 5
    ang = np.deg2rad(np.linspace(-60, 60, M))
    path = str(tmp_path / "b.sofa")
    with h5py.File(path, "w") as f:
        f["Data.IR"] = rng.standard_normal((M, 2, 3, 240))
        f["Data.SamplingRate"] = np.array([48000.0])
        f["ListenerView"] = np.stack([np.cos(ang), np.sin(ang),
                                      np.zeros(M)], 1)
        f["SourcePosition"] = np.stack([np.arange(M) * 10.0, np.zeros(M),
                                        np.full(M, 2.0)], 1)
    got, want = trv.load_sofa_brir(path, 16000), tool_load(path, 16000)
    assert got[0].dtype == want[0].dtype == np.float32
    assert got[0].shape == (M, 2, 3, 80)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    views = (got[1], None, np.zeros((M, 1)) + 400.0, np.full((M, 2), 30.0))
    poss = (got[2], got[2], None, None)
    for view, pos in zip(views, poss):
        ya, ta = trv.extract_head_yaw(view, pos, M)
        yb, tb = tool_yaw(view, pos, M)
        assert ta == tb
        np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("scene", ["spirit", "auditorium", "room"])
def test_build_synthesizer_scene_matches_jax(scene):
    sys.path.insert(0, REPO)
    from tools.generate_binaural_data import build_synthesizer as tool_build
    segs = tsy.make_test_segments(2)
    ts = tsy.build_synthesizer(scene, None, segs, 16000, num_lags=24,
                               device="cpu")
    js = tool_build(scene, None, segs, 16000, num_lags=24)
    assert isinstance(ts, trv.ReverbSynthesizer)
    assert ts.num_lags == 24 and ts.n_speakers == js.n_speakers
    np.testing.assert_array_equal(ts.sector_table.numpy(), js._sector_np)
    np.testing.assert_array_equal(ts.norm_table.numpy(), js._norm_np)
    np.testing.assert_array_equal(
        ts.bank["H"].real.numpy(),
        np.transpose(np.asarray(js._bank["H_re"]), (0, 2, 1, 3)))
    wl, wr, x3, y = ts.sample_batch(torch.Generator().manual_seed(0), 2)
    assert x3.shape == (2, 24) and y.shape == (2, 56)
