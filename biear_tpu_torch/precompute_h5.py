#!/usr/bin/env python
"""Build training splits: the active (wavL, wavR, CC, y) and the passive
(magnitude and phase planes, CC, y) schemas.

    python -m biear_tpu_torch.precompute_h5 (--from-dir DIR | --synth N) \\
        [--out-active A.h5|A.shard] [--out-passive P.h5|P.shard] \\
        [--sofa FILE] [--n-src K] [--seed 0] [--max-samples M] \\
        [--device cpu]

Counterpart of ``tools/precompute_h5.py``. Two sources:
  * --from-dir: the wav + npz pairs of ``generate_binaural_data`` (wavs
    read as int16 / 32768, labels from the npz fields);
  * --synth N: N samples of the anechoic synthesizer (an HRIR SOFA file or
    the built-in bank, the modulated-noise pool) in batches of 256 from
    one generator seeded with --seed (--n-src forces the source count).

The CC feature (``ops/xcorr.py``, the ``cc_lags`` kernel on the card) and
the passive features (``ops/features.py::passive_features``) run batched,
512 rows at a time, on the card unless ``--device cpu`` is given. The
output format follows the path's extension: ``.h5`` writes the H5 schema
(needs ``h5py``), ``.shard`` the file that ``h5_to_shard`` makes from that
H5 (the active waveforms as int16, every other field float32), which the
runner reads with DATA_FORMAT: shard and the evaluator with
--test-shard.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from .data.h5io import save_active_h5, save_passive_h5
from .data.labels import build_label_from_npz_dict
from .data.shard import write_shard
from .data.synth import (AnechoicSynthesizer, load_sofa_hrir,
                         make_test_hrir_bank, make_test_segments)
from .device import resolve_device
from .ops.features import passive_features
from .ops.xcorr import cross_correlation_feature

BATCH = 512
SYNTH_BATCH = 256


def _read_wav(path):
    """A wav file -> (float32 samples, rate): int16 / 32768, int32 /
    2^31, floats as they are."""
    from scipy.io import wavfile
    fs, audio = wavfile.read(path)
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / 32768.0
    elif audio.dtype == np.int32:
        audio = audio.astype(np.float32) / 2147483648.0
    else:
        audio = audio.astype(np.float32)
    return audio, fs


def load_samples_from_dir(dataset_dir, max_samples=None):
    """npz + wav pairs (sorted by name) -> (wavL (N, T), wavR, y (N, 56),
    fs). A mono wav feeds both ears; an npz's audio_path that does not
    exist is looked up by its base name in dataset_dir."""
    npz_files = sorted(glob.glob(os.path.join(dataset_dir, "*.npz")))
    if max_samples:
        npz_files = npz_files[:max_samples]
    if not npz_files:
        raise FileNotFoundError(f"no .npz files in {dataset_dir}")
    wavLs, wavRs, ys = [], [], []
    fs = None
    for p in npz_files:
        d = np.load(p, allow_pickle=True)
        wav_path = str(d["audio_path"])
        if not os.path.isabs(wav_path) or not os.path.exists(wav_path):
            cand = os.path.join(dataset_dir, os.path.basename(wav_path))
            wav_path = cand if os.path.exists(cand) else wav_path
        audio, fs = _read_wav(wav_path)
        if audio.ndim == 1:
            left = right = audio
        else:
            left, right = audio[:, 0], audio[:, 1]
        wavLs.append(left.astype(np.float32))
        wavRs.append(right.astype(np.float32))
        ys.append(build_label_from_npz_dict(d))
    return np.stack(wavLs), np.stack(wavRs), np.stack(ys), fs


def _batches(wavL, wavR, batch: int, device):
    for s in range(0, len(wavL), batch):
        yield (torch.as_tensor(wavL[s:s + batch], device=device),
               torch.as_tensor(wavR[s:s + batch], device=device))


def _write(out_path, arrays, dtypes, save_h5):
    if out_path.endswith(".shard"):
        write_shard(out_path, [np.asarray(a, np.float32) for a in arrays],
                    dtypes)
    else:
        save_h5(out_path, *arrays)


def build_active(wavL, wavR, y, fs, out_path, batch: int = BATCH,
                 device=None):
    """x1 / x2 = the waveforms, x3 = their CC feature, y; written as H5
    or ``.shard`` by out_path's extension. Returns the arrays written."""
    device = resolve_device(device)
    with torch.no_grad():
        x3 = np.concatenate([cross_correlation_feature(l, r, fs).cpu().numpy()
                             for l, r in _batches(wavL, wavR, batch, device)])
    arrays = (wavL, wavR, x3, y)
    _write(out_path, arrays, ["i16", "i16", "f32", "f32"], save_active_h5)
    print(f"[active] wrote {len(wavL)} samples -> {out_path}")
    return arrays


def build_passive(wavL, wavR, y, fs, out_path, batch: int = BATCH,
                  device=None):
    """x1 / x2 = magnitude dB of the left / right ear, x3 = CC, x4 / x5 =
    phase; written as H5 or ``.shard`` by out_path's extension. Returns
    the arrays written."""
    device = resolve_device(device)
    parts = []
    with torch.no_grad():
        for l, r in _batches(wavL, wavR, batch, device):
            m1, p1 = passive_features(l, fs)
            m2, p2 = passive_features(r, fs)
            cc = cross_correlation_feature(l, r, fs)
            parts.append([a.cpu().numpy() for a in (m1, m2, cc, p1, p2)])
    arrays = (*(np.concatenate(p) for p in zip(*parts)), y)
    _write(out_path, arrays, None, save_passive_h5)
    print(f"[passive] wrote {len(wavL)} samples -> {out_path}")
    return arrays


def synth_samples(n: int, seed: int, sofa: str | None = None,
                  n_src: int | None = None, device=None):
    """n samples of the anechoic synthesizer over the modulated-noise pool
    (the SOFA bank or the built-in one): (wavL, wavR, y, fs) on the
    host."""
    ir, az, dist = load_sofa_hrir(sofa) if sofa else make_test_hrir_bank()
    synth = AnechoicSynthesizer(ir, az, dist, make_test_segments(64),
                                device=device)
    gen = torch.Generator(device=synth.device).manual_seed(seed)
    parts = []
    for s in range(0, n, SYNTH_BATCH):
        wl, wr, _, yy = synth.sample_batch(gen, min(SYNTH_BATCH, n - s),
                                           n_src=n_src)
        parts.append([a.cpu().numpy() for a in (wl, wr, yy)])
    wavL, wavR, y = (np.concatenate(p) for p in zip(*parts))
    return wavL, wavR, y, synth.fs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--from-dir", help="directory of npz/wav sample pairs")
    ap.add_argument("--synth", type=int, default=0,
                    help="synthesize N samples on the device instead")
    ap.add_argument("--sofa", default=None, help="HRIR SOFA for --synth")
    ap.add_argument("--n-src", type=int, default=None,
                    help="force source count (test splits)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-active", default=None,
                    help="active split, .h5 or .shard")
    ap.add_argument("--out-passive", default=None,
                    help="passive split, .h5 or .shard")
    ap.add_argument("--max-samples", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)
    if not (args.from_dir or args.synth):
        ap.error("need --from-dir or --synth N")
    if not (args.out_active or args.out_passive):
        ap.error("need --out-active and/or --out-passive")
    device = resolve_device(args.device)

    if args.from_dir:
        wavL, wavR, y, fs = load_samples_from_dir(args.from_dir,
                                                  args.max_samples)
    else:
        wavL, wavR, y, fs = synth_samples(args.synth, args.seed, args.sofa,
                                          args.n_src, device)
    out = {}
    if args.out_active:
        out["active"] = build_active(wavL, wavR, y, fs, args.out_active,
                                     device=device)
    if args.out_passive:
        out["passive"] = build_passive(wavL, wavR, y, fs, args.out_passive,
                                       device=device)
    return out


if __name__ == "__main__":
    main()
