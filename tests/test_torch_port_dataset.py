"""The port's offline dataset path held against the JAX package and the
JAX tools (CPU).

  * ``data/labels.py``: the five label functions bit for bit on a grid of
    azimuths (0, 44.999, 45, 359.999, negatives, beyond 360) and distances,
    sector ids outside [0, 8) included;
  * ``sample_batch_meta`` (anechoic, auditorium, spirit) on JAX's draws,
    injected into the port through ``scene_batched``: waveforms within
    2e-5 (the f32 synthesis tolerance of tests/test_torch_port_synth.py),
    the CC feature at the CC tolerance (2e-5 relative, 2e-4 absolute),
    labels and meta bit for bit; the host tables equal JAX's;
  * the label fields of ``generate_binaural_data`` from JAX's meta, field
    by field in value and dtype;
  * ``write_split`` at N = 7 and 9 with test thirds: JAX's file names, npz
    keys, dtypes and shapes; JAX's ``load_samples_from_dir`` reads the
    port's directory and returns the port's labels and waveforms;
  * ``collect_speech_pool`` and the SPHERE reader bit for bit against the
    tools' originals on int16, float, stereo, 8 kHz, too-short and SPHERE
    (PCM in both byte orders, mu-law, shorten) files;
  * ``build_active`` / ``build_passive`` on 8 full-width rows: x1, x2 and
    y bit for bit, x3 at the CC tolerance, the passive features within
    tests/test_torch_port_passive.py's limits (1e-3 rad, 8.7e-3 dB where
    JAX's magnitude is above -60 dB); the H5 read by JAX's
    ``load_arrays_from_h5`` and H5 datasets; the ``.shard`` byte-identical
    to the port's ``h5_to_shard`` of its own H5, and the port's
    ``h5_to_shard`` of a JAX-written H5 byte-identical to the JAX tool's;
  * the offline feature library bit for bit against JAX's numpy
    functions, and against tests/goldens at tests/test_features.py's
    tolerances.

torch's random streams are not JAX's: the draws are injected, or the
tests compare formats and round trips, never the draws themselves.
"""

import os
import struct
import sys

import numpy as np
import pytest
import torch

import jax

from biear_tpu.data import h5io as jh5
from biear_tpu.data import labels as jlab
from biear_tpu.data import synth as jsy
from biear_tpu.data import synth_reverb as jrv
from biear_tpu.ops import features as jfe

import tools.generate_binaural_data as jgen
import tools.h5_to_shard as jh2s
import tools.precompute_h5 as jpre
import tools.sphere as jsph

from biear_tpu_torch import generate_binaural_data as tgen
from biear_tpu_torch import h5_to_shard as th2s
from biear_tpu_torch import precompute_h5 as tpre
from biear_tpu_torch.data import h5io as th5
from biear_tpu_torch.data import labels as tlab
from biear_tpu_torch.data import sphere as tsph
from biear_tpu_torch.data import synth as tsy
from biear_tpu_torch.data import synth_reverb as trv
from biear_tpu_torch.kernels import LAUNCHES
from biear_tpu_torch.ops import features as tfe

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
WAVE_TOL = 2e-5
CC_RTOL, CC_ATOL = 2e-5, 2e-4
FEAT_TOL = 1e-3                                   # relative, and rad
MAG_DB_TOL = 20.0 * np.log10(1.0 + FEAT_TOL)      # 8.7e-3 dB
SCENES = ("anechoic", "auditorium", "spirit")
B = 6


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------- labels ----------------

AZ = [0.0, 1e-4, 22.5, 44.999, 45.0, 45.001, 89.999, 90.0, 180.0, 314.999,
      315.0, 359.999, 360.0, -0.001, -10.0, -45.0, -359.999, 405.5, 720.25]
DIST = [0.0, 0.2, 0.5, 0.74, 0.75, 0.76, 1.0, 1.5, 1.51, 2.5, 2.6, 3.0, 3.97,
        5.49, -1.0]


def _pack_cases():
    rng = np.random.default_rng(4)
    cases = [([3], [0.25], [1], 1), ([-1, 2], [0.5, 0.75], [0, 3], 2),
             ([7, 8, 0], [1.0, 0.1, 0.002], [2, 1, 0], 3),
             ([5, 6], [0.3, 0.4], [1, 2], 1), ([], [], [], 0)]
    for _ in range(6):
        n = int(rng.integers(1, 4))
        cases.append((rng.choice(np.arange(-1, 9), n, replace=False),
                      rng.uniform(0, 1, n).astype(np.float32),
                      rng.integers(0, 4, n), n))
    return cases


@pytest.mark.parametrize("fn", ["aoa_to_sector_label", "sector_label",
                                "distance_to_class_index", "pack_label",
                                "build_label_from_npz_dict",
                                "split_y_matrix"])
def test_label_functions_match_jax_bit_for_bit(fn):
    if fn == "aoa_to_sector_label":
        for az in AZ:
            for n in (8, 4):
                assert (tlab.aoa_to_sector_label(az, n)
                        == jlab.aoa_to_sector_label(az, n)), az
    elif fn == "sector_label":
        for az in [a % 360.0 for a in AZ] + [-5.0, 400.0]:
            assert tgen._sector_label(az) == jgen._sector_label(az), az
    elif fn == "distance_to_class_index":
        for d in DIST:
            assert (tlab.distance_to_class_index(d)
                    == jlab.distance_to_class_index(d)), d
    elif fn == "pack_label":
        for c in _pack_cases():
            got, want = tlab.pack_label(*c), jlab.pack_label(*c)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    elif fn == "build_label_from_npz_dict":
        for sid, ang, dcls, n in _pack_cases():
            d = dict(sector_id=np.asarray(sid, np.int64),
                     sector_angle_norm=np.asarray(ang, np.float32),
                     distance_class=np.asarray(dcls, np.int64),
                     num_sources=np.int64(n))
            np.testing.assert_array_equal(tlab.build_label_from_npz_dict(d),
                                          jlab.build_label_from_npz_dict(d))
    else:
        y = np.random.default_rng(1).uniform(size=(5, 56)).astype(np.float32)
        got, want = tlab.split_y_matrix(y), jlab.split_y_matrix(y)
        assert len(got) == len(want) == 24
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# ---------------- sample_batch_meta on JAX's draws ----------------

def _synths(scene):
    """(JAX synthesizer, port synthesizer) of a scene over the built-in
    bank; the room scenes get a pool of one fs-sample segment, which fixes
    the segment draw JAX's meta does not report."""
    if scene == "anechoic":
        ir, az, dist = tsy.make_test_hrir_bank()
        segs = tsy.make_test_segments(8)
        return (jsy.AnechoicSynthesizer(ir, az, dist, segs),
                tsy.AnechoicSynthesizer(ir, az, dist, segs, device="cpu"))
    sxy = trv.scene_speaker_xy(scene, 3 if scene == "spirit" else 6)
    ir, yaw, sxy = trv.make_test_brir_bank(speaker_xy=sxy)
    segs = tsy.make_test_segments(1, seed=4)
    return (jrv.ReverbSynthesizer(ir, yaw, sxy, segs),
            trv.ReverbSynthesizer(ir, yaw, sxy, segs, device="cpu"))


@pytest.fixture(scope="module", params=SCENES)
def scene_batch(request):
    """A scene's synthesizers, JAX's sample_batch_meta batch (numpy) and
    its draws in the port's scene_batched layout."""
    scene = request.param
    js, ts = _synths(scene)
    key = jax.random.PRNGKey(3)
    wl, wr, x3, y, meta = js.sample_batch_meta(key, B)
    want = [np.asarray(a) for a in (wl, wr, x3, y)]
    meta = {k: np.asarray(v) for k, v in meta.items()}
    if scene == "anechoic":
        draws = [_t(a) for a in js._scene_batched(key, B, 0)]
        draws[0] = draws[0].bool()
        draws[1:] = [d.long() for d in draws[1:]]
    else:
        zeros = torch.zeros((B, 3), dtype=torch.long)
        draws = [_t(meta["head_index"].astype(np.int64)),
                 _t(meta["active"] > 0.5),
                 _t(meta["sector_id"].astype(np.int64)),
                 _t(meta["speaker_id"].astype(np.int64)), zeros, zeros]
    return scene, js, ts, want, meta, draws


def test_sample_batch_meta_matches_jax_on_its_draws(scene_batch,
                                                     monkeypatch):
    scene, js, ts, want, meta, draws = scene_batch
    monkeypatch.setattr(ts, "scene_batched", lambda gen, n, nsf: draws)
    LAUNCHES.clear()
    *got, got_meta = ts.sample_batch_meta(torch.Generator().manual_seed(0),
                                          B)
    assert sum(LAUNCHES.values()) == 0
    got = [a.numpy() for a in got]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=WAVE_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=WAVE_TOL)
    np.testing.assert_allclose(got[2], want[2], rtol=CC_RTOL, atol=CC_ATOL)
    np.testing.assert_array_equal(got[3], want[3])
    assert set(got_meta) == set(meta)
    for k, v in meta.items():
        assert got_meta[k].dtype == v.dtype == np.float32, k
        np.testing.assert_array_equal(got_meta[k], v, err_msg=k)
    tables = (("_az_np", "_dist_np", "_dcls_np", "_sec_np")
              if scene == "anechoic" else
              ("_yaw_np", "_sp_dist_np", "_sp_az_world_np", "_rel_np",
               "_dcls_np"))
    for name in tables:
        a, b = getattr(ts, name), getattr(js, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    if scene != "anechoic":
        assert (trv.OTHER_THRESH_M, trv.OTHER_CLASS_ID) == (
            jrv.OTHER_THRESH_M, jrv.OTHER_CLASS_ID)


def test_label_fields_match_jax_on_its_meta(scene_batch):
    scene, js, ts, _, meta, _ = scene_batch
    for b in range(B):
        if scene == "anechoic":
            got = tgen._anechoic_labels(ts, meta, b)
            want = jgen._anechoic_labels(js, meta, b)
        else:
            got = tgen._room_labels(ts, meta, b, scene)
            want = jgen._room_labels(js, meta, b, scene)
        assert list(got) == list(want)
        for k, v in want.items():
            assert type(got[k]) is type(v), k
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


# ---------------- write_split ----------------

@pytest.fixture(scope="module")
def anechoic_pair():
    return _synths("anechoic")


@pytest.mark.parametrize("num", [7, 9])
def test_write_split_matches_jax_format(anechoic_pair, num, tmp_path):
    from scipy.io import wavfile

    js, ts = anechoic_pair
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    y = tgen.write_split(ts, tdir, "t", num, 5, True, 16000)
    jgen.write_split(js, jdir, "t", num, 5, True, 16000)
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir))
    assert len(names) == 2 * num
    third = num // 3
    want_counts = [1] * third + [2] * third + [3] * (num - 2 * third)
    for i in range(num):
        stem = f"t_{i:06d}"
        got, want = (np.load(os.path.join(d, stem + ".npz"))
                     for d in (tdir, jdir))
        assert list(got.keys()) == list(want.keys())
        for k in want:
            assert got[k].dtype.kind == want[k].dtype.kind, k
            if k != "audio_path":
                assert got[k].dtype == want[k].dtype, k
                assert got[k].shape == want[k].shape, k
        assert str(got["audio_path"]) == os.path.join(tdir, stem + ".wav")
        assert int(got["num_sources"]) == want_counts[i]
        np.testing.assert_array_equal(tlab.build_label_from_npz_dict(got),
                                      y[i])
        (rt, wt), (rj, wj) = (wavfile.read(os.path.join(d, stem + ".wav"))
                              for d in (tdir, jdir))
        assert rt == rj == 16000
        assert wt.dtype == wj.dtype == np.int16 and wt.shape == wj.shape
    # JAX's reader takes the port's directory, and the port's reader
    # returns the same arrays
    wl, wr, yy, fs = jpre.load_samples_from_dir(tdir)
    assert fs == 16000 and wl.shape == (num, 16000)
    np.testing.assert_array_equal(yy, y)
    for a, b in zip(tpre.load_samples_from_dir(tdir), (wl, wr, yy, fs)):
        np.testing.assert_array_equal(a, b)
    wav = wavfile.read(os.path.join(tdir, "t_000000.wav"))[1]
    np.testing.assert_array_equal(wl[0], wav[:, 0].astype(np.float32)
                                  / np.float32(32768.0))


def test_write_split_truncates_to_int16_and_batches_by_third(anechoic_pair,
                                                             tmp_path,
                                                             monkeypatch):
    """The wav is (clip(x, -1, 1) * 32767) truncated toward zero; the
    batches stop at each third's boundary with its forced count; with
    num < 3 no count is forced."""
    from scipy.io import wavfile

    _, ts = anechoic_pair
    calls = []
    real = ts.sample_batch_meta

    def spy(gen, n, n_src=None):
        calls.append((n, n_src))
        out = real(gen, n, n_src=n_src)
        spy.last = out
        return out

    monkeypatch.setattr(ts, "sample_batch_meta", spy)
    monkeypatch.setattr(tgen, "BATCH", 4)
    tgen.write_split(ts, str(tmp_path / "a"), "a", 16, 1, True, 16000)
    assert calls == [(4, 1), (1, 1), (4, 2), (1, 2), (4, 3), (2, 3)]
    wl, wr = (a[-1].numpy() for a in spy.last[:2])
    got = wavfile.read(str(tmp_path / "a" / "a_000015.wav"))[1]
    want = (np.clip(np.stack([wl, wr], 1), -1, 1) * 32767).astype(np.int16)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, np.round(np.stack([wl, wr], 1) * 32767)
                              .astype(np.int16))
    calls.clear()
    tgen.write_split(ts, str(tmp_path / "b"), "b", 2, 1, True, 16000)
    assert calls == [(2, None)]


# ---------------- speech pool and SPHERE ----------------

def _sphere_bytes(samples, fs, coding="pcm", byte_format="01", channels=1):
    n_bytes = 1 if coding == "ulaw" else 2
    fields = [f"sample_rate -i {fs}", f"channel_count -i {channels}",
              f"sample_n_bytes -i {n_bytes}",
              f"sample_count -i {len(samples) // channels}",
              f"sample_coding -s{len(coding)} {coding}",
              f"sample_byte_format -s2 {byte_format}", "end_head"]
    head = ("NIST_1A\n   1024\n" + "\n".join(fields) + "\n").encode()
    head += b" " * (1024 - len(head))
    if coding == "ulaw":
        body = np.asarray(samples, np.uint8).tobytes()
    else:
        body = np.asarray(samples, ">i2" if byte_format == "10"
                          else "<i2").tobytes()
    return head + body


def _sphere_files(d, rng):
    """name -> path of SPHERE files under d (the .WAV name TIMIT uses)."""
    files = {
        "pcm01": _sphere_bytes(rng.integers(-9000, 9000, 24000), 16000),
        "pcm10": _sphere_bytes(rng.integers(-9000, 9000, 20000), 16000,
                               byte_format="10"),
        "ulaw": _sphere_bytes(rng.integers(0, 256, 21000), 16000, "ulaw"),
        "stereo": _sphere_bytes(rng.integers(-500, 500, 2 * 20000), 16000,
                                channels=2),
        "shorten": _sphere_bytes(rng.integers(-9, 9, 20000), 16000,
                                 coding="pcm,embedded-shorten-v2.00"),
    }
    out = {}
    for name, data in files.items():
        p = os.path.join(d, "timit", f"{name}.WAV")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)
        out[name] = p
    return out


@pytest.mark.parametrize("name", ["pcm01", "pcm10", "ulaw", "stereo",
                                  "shorten", "riff"])
def test_sphere_reader_matches_the_tool(name, tmp_path):
    from scipy.io import wavfile

    paths = _sphere_files(str(tmp_path), np.random.default_rng(2))
    if name == "riff":
        p = str(tmp_path / "x.wav")
        wavfile.write(p, 16000, np.zeros(100, np.int16))
        for mod in (tsph, jsph):
            with pytest.raises(ValueError, match="bad magic"):
                mod.read_sphere(p)
        return
    if name == "shorten":
        for mod in (tsph, jsph):
            with pytest.raises(ValueError, match="shorten"):
                mod.read_sphere(paths[name])
        return
    (fs, got), (fs_j, want) = (m.read_sphere(paths[name])
                               for m in (tsph, jsph))
    assert fs == fs_j == 16000 and got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)


def test_collect_speech_pool_matches_the_tool(tmp_path):
    from scipy.io import wavfile

    rng = np.random.default_rng(8)
    d = str(tmp_path)
    wavfile.write(os.path.join(d, "a_int16.wav"), 16000,
                  rng.integers(-20000, 20000, 24000).astype(np.int16))
    wavfile.write(os.path.join(d, "b_float.wav"), 16000,
                  rng.uniform(-0.9, 0.9, 21000).astype(np.float32))
    wavfile.write(os.path.join(d, "c_stereo.wav"), 16000,
                  rng.integers(-3000, 3000, (22000, 2)).astype(np.int16))
    wavfile.write(os.path.join(d, "d_8k.wav"), 8000,
                  rng.integers(-3000, 3000, 12000).astype(np.int16))
    wavfile.write(os.path.join(d, "e_short.wav"), 16000,
                  rng.integers(-3000, 3000, 8000).astype(np.int16))
    os.makedirs(os.path.join(d, "sub"))
    wavfile.write(os.path.join(d, "sub", "f_upper.WAV"), 16000,
                  rng.uniform(-3, 3, 20000).astype(np.float32))
    _sphere_files(d, rng)
    got = tgen.collect_speech_pool(d, 16000, seed=3)
    want = jgen.collect_speech_pool(d, 16000, seed=3)
    # int16, float, stereo, 8 kHz, .WAV float, SPHERE pcm01, pcm10, ulaw,
    # stereo; too short and shorten skipped
    assert got.shape == want.shape == (9, 19200)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tgen.collect_speech_pool(d, 8000, seg_len_sec=1.0, max_files=4,
                                 seed=1),
        jgen.collect_speech_pool(d, 8000, seg_len_sec=1.0, max_files=4,
                                 seed=1))
    for mod in (tgen, jgen):
        with pytest.raises(FileNotFoundError):
            mod.collect_speech_pool(str(tmp_path / "none"), 16000)
        with pytest.raises(RuntimeError, match="no usable"):
            mod.collect_speech_pool(d, 16000, seg_len_sec=9.0)


# ---------------- build_active / build_passive ----------------

@pytest.fixture(scope="module")
def rows8():
    """8 full-width rows from the port's synthesizer (wavL, wavR, y)."""
    _, ts = _synths("anechoic")
    wl, wr, _, y = ts.sample_batch(torch.Generator().manual_seed(6), 8)
    return wl.numpy(), wr.numpy(), y.numpy()


def _shard_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _run_tool(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["tool"] + argv)
    main()


@pytest.mark.parametrize("schema", ["active", "passive"])
def test_build_splits_match_jax(rows8, schema, tmp_path, monkeypatch):
    wl, wr, y = rows8
    port_fn = getattr(tpre, f"build_{schema}")
    jax_fn = getattr(jpre, f"build_{schema}")
    th5_path, jh5_path = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
    LAUNCHES.clear()
    port_fn(wl, wr, y, 16000, th5_path, device="cpu")
    assert sum(LAUNCHES.values()) == 0
    jax_fn(wl, wr, y, 16000, jh5_path)
    got = jh5.load_arrays_from_h5(th5_path)
    want = jh5.load_arrays_from_h5(jh5_path)
    for a, b in zip(th5.load_arrays_from_h5(th5_path), got):
        np.testing.assert_array_equal(a, b)
    n = 4 if schema == "active" else 6
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    import h5py
    with h5py.File(th5_path) as ft, h5py.File(jh5_path) as fj:
        assert list(ft) == list(fj)
        for k in fj:
            assert ft[k].chunks == fj[k].chunks, k
    np.testing.assert_array_equal(got[-1], y)
    if schema == "active":
        np.testing.assert_array_equal(got[0], wl)
        np.testing.assert_array_equal(got[1], wr)
        np.testing.assert_allclose(got[2], want[2], rtol=CC_RTOL,
                                   atol=CC_ATOL)
        ds = jh5.ActiveH5Dataset(th5_path)
    else:
        np.testing.assert_allclose(got[2], want[2], rtol=CC_RTOL,
                                   atol=CC_ATOL)
        for mag, ph, jmag, jph in ((got[0], got[3], want[0], want[3]),
                                   (got[1], got[4], want[1], want[4])):
            strong = jmag > -60.0
            assert strong.mean() > 0.1
            assert np.abs(mag - jmag)[strong].max() <= MAG_DB_TOL
            dphi = np.angle(np.exp(1j * (ph.astype(np.float64) - jph)))
            assert np.abs(dphi)[strong].max() <= FEAT_TOL
            assert np.all(mag[:, 18] == -80.0)
        ds = jh5.PassiveH5Dataset(th5_path)
    assert len(ds) == 8
    for a, b in zip(ds.rows(np.arange(8)), got):
        np.testing.assert_array_equal(a, b)

    # .shard: the port's direct write equals its h5_to_shard of its H5
    shard = str(tmp_path / "t.shard")
    port_fn(wl, wr, y, 16000, shard, device="cpu")
    th2s.main([th5_path, str(tmp_path / "t2.shard")])
    assert _shard_bytes(shard) == _shard_bytes(str(tmp_path / "t2.shard"))
    magic, version, n_fields, n_rows = struct.unpack(
        "<QII Q", _shard_bytes(shard)[:24])
    assert (n_fields, n_rows) == (n, 8)
    # the port's h5_to_shard of JAX's H5 equals the JAX tool's output
    for flag in ([], ["--no-wav-i16"]):
        th2s.main([jh5_path, str(tmp_path / "p.shard")] + flag)
        _run_tool(jh2s.main, [jh5_path, str(tmp_path / "j.shard")] + flag,
                  monkeypatch)
        assert (_shard_bytes(str(tmp_path / "p.shard"))
                == _shard_bytes(str(tmp_path / "j.shard"))), flag


def test_precompute_cli_from_dir_and_synth(tmp_path):
    """The CLI on the CPU: --from-dir through both schemas (.h5 and
    .shard), --synth with a forced source count; no flags is an error."""
    from biear_tpu_torch.data.shard import ShardDataset

    _, ts = _synths("anechoic")
    d = str(tmp_path / "split")
    y = tgen.write_split(ts, d, "s", 5, 2, False, 16000)
    out = tpre.main(["--from-dir", d, "--out-active", str(tmp_path / "a.h5"),
                     "--out-passive", str(tmp_path / "p.shard"),
                     "--max-samples", "4", "--device", "cpu"])
    np.testing.assert_array_equal(out["active"][3], y[:4])
    ps = ShardDataset(str(tmp_path / "p.shard"))
    assert len(ps) == 4 and ps.n_fields == 6
    np.testing.assert_array_equal(ps.rows(np.arange(4))[5], y[:4])
    out = tpre.main(["--synth", "3", "--n-src", "2", "--seed", "1",
                     "--out-active", str(tmp_path / "s.shard"),
                     "--device", "cpu"])
    wl, wr, x3, yy = out["active"]
    assert wl.shape == (3, 16000) and x3.shape == (3, 100)
    assert np.all(yy.reshape(3, 8, 7)[:, :, 0].sum(1) == 2)
    sh = ShardDataset(str(tmp_path / "s.shard")).rows(np.arange(3))
    np.testing.assert_array_equal(
        sh[0], np.round(wl * 32767.0).astype(np.int16).astype(np.float32)
        * np.float32(1.0 / 32767.0))
    np.testing.assert_array_equal(sh[2], x3)
    for argv in ([], ["--synth", "2"]):
        with pytest.raises(SystemExit):
            tpre.main(argv + ["--device", "cpu"])


# ---------------- the offline feature library ----------------

def _wav(n=16000, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


LIBRARY = {
    "stft_center_false": lambda m, w: m.stft_center_false(w, 1024, 842, 842),
    "stft_gammatone_mag_phase": lambda m, w: m.stft_gammatone_mag_phase(
        w, 16000),
    "compute_gammatone_mag_phase": lambda m, w: m.compute_gammatone_mag_phase(
        w, 16000, data_dim=40, timesteps=25, fmin=80.0, fmax=6000.0),
    "compute_gammatone_feature_stft": lambda m, w:
        m.compute_gammatone_feature_stft(w, 16000),
    "erb_space_slaney": lambda m, w: m.erb_space_slaney(50.0, 8000.0, 64),
    "make_erb_filters": lambda m, w: m.make_erb_filters(
        16000, m.erb_space_slaney(50.0, 8000.0, 24), width=1.2),
    "erb_filterbank_slaney": lambda m, w: m.erb_filterbank_slaney(
        w[:4000], m.make_erb_filters(16000, [300.0, 1000.0, 4000.0])),
    "gtgram_slaney": lambda m, w: m.gtgram_slaney(w[:8000], 8000, 0.05,
                                                  0.025, 8, 50.0),
    "compute_gammatone_feature": lambda m, w: m.compute_gammatone_feature(
        w[:6000], 8000, data_dim=12, timesteps=5),
    "compute_gammatone_feature_short": lambda m, w:
        m.compute_gammatone_feature(w[:4000], 8000, data_dim=6, timesteps=9),
    "compute_gammatone_mag_phase_direct": lambda m, w:
        m.compute_gammatone_mag_phase_direct(w[:4000], 8000, data_dim=12,
                                             timesteps=5),
}


@pytest.mark.parametrize("name", sorted(LIBRARY))
def test_offline_feature_library_matches_jax_bit_for_bit(name):
    w = _wav(seed=len(name))
    got, want = LIBRARY[name](tfe, w), LIBRARY[name](jfe, w)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("golden", ["offline", "scipy"])
def test_offline_feature_library_matches_the_goldens(golden):
    """tests/test_features.py's golden checks, on the port's functions."""
    if golden == "offline":
        g = np.load(os.path.join(GOLDENS, "offline_features.npz"))
        feat = tfe.compute_gammatone_feature(g["wav"], 16000, data_dim=32,
                                             timesteps=50)
        np.testing.assert_allclose(feat, g["gtgram"], atol=2e-4)
        np.testing.assert_allclose(tfe.erb_space_slaney(50.0, 8000.0, 32),
                                   g["cfs"], rtol=1e-12)
        n_fft, hop, win = tfe._stft_params(len(g["wav"]), 19)
        assert (n_fft, hop, win) == (int(g["n_fft"]), int(g["hop"]),
                                     int(g["win"]))
        S = tfe.stft_center_false(g["wav"], n_fft, hop, win)
        np.testing.assert_allclose(S.real, g["stft_re"], atol=2e-3)
        np.testing.assert_allclose(S.imag, g["stft_im"], atol=2e-3)
    else:
        g = np.load(os.path.join(GOLDENS, "scipy_features.npz"))
        S = tfe.stft_center_false(g["wav"], int(g["n_fft"]), int(g["hop"]),
                                  int(g["win"]))
        S_g = (g["stft_re"] + 1j * g["stft_im"])[:, :S.shape[1]]
        np.testing.assert_allclose(S.real, S_g.real, atol=1e-4)
        np.testing.assert_allclose(S.imag, S_g.imag, atol=1e-4)
        db, ph = tfe.compute_gammatone_mag_phase_direct(g["wav"], 16000)
        assert db.shape == (int(g["iir_timesteps"]), int(g["iir_data_dim"]))
        np.testing.assert_allclose(db, g["iir_db"], atol=1e-4)
        dphi = np.angle(np.exp(1j * (ph - g["iir_ph"])))
        assert np.abs(dphi).max() < 1e-5
