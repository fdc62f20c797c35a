#!/usr/bin/env python
"""Write a binaural dataset split: wav + npz pairs, one per sample.

    python -m biear_tpu_torch.generate_binaural_data --out-root DIR \\
        [--scene anechoic|auditorium|spirit|room] [--sofa FILE] \\
        [--speech-dir DIR] [--name anechoic_train] [--num 1000] [--seed 0] \\
        [--test-thirds] [--device cpu]

Counterpart of ``tools/generate_binaural_data.py``, with its flags and
its output format. Per sample ``{name}_{i:06d}.wav`` (stereo int16, the
waveform clipped to [-1, 1] and truncated from x * 32767) and
``{name}_{i:06d}.npz`` with audio_path, num_sources, aoa_deg, distance_m,
sector_id, sector_angle_norm, distance_class; the spirit scene adds
speaker_id, head_yaw_deg, head_index, dist_protos, other_thresh_m,
other_class_id, az_offset_deg and head_yaw_offset_deg. distance_m is the
source's real distance and distance_class its true 5-class id (class 4,
"other", included for the room scenes). ``precompute_h5 --from-dir``
turns such a directory into training splits.

Scenes: anechoic (an HRIR SOFA file, or the built-in test bank),
auditorium and spirit (a BRIR SOFA file with the scene's loudspeaker
geometry, or the scene's built-in bank). The samples come from the port's
synthesizers (``data/synth.py``, ``data/synth_reverb.py``) in batches of
256 drawn from one ``torch.Generator`` seeded with --seed, on the card
unless ``--device cpu`` is given; the speech pool is a directory of mono
wavs (PCM, float, or NIST SPHERE as TIMIT ships them) or the built-in
modulated-noise segments. torch's random streams are not JAX's, so a
seed writes other scenes than the JAX tool's.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from .data.labels import DIST_CLASSES
from .data.synth import build_synthesizer, make_test_segments
from .data.synth_reverb import OTHER_CLASS_ID, OTHER_THRESH_M
from .device import resolve_device

N_SECTOR_DEG = 45.0
BATCH = 256


def collect_speech_pool(wav_dir, fs_target: int, seg_len_sec: float = 1.2,
                        max_files: int | None = None, seed: int = 0):
    """A directory of mono wavs (searched recursively, *.wav and *.WAV) ->
    (P, seg_len) float32 pool: the first channel, integer samples scaled
    by 1 / 32768 (where the peak exceeds 2), polyphase-resampled to
    fs_target, one random crop of seg_len_sec per file; files shorter than
    that, and unreadable SPHERE files, are skipped."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    from .data.sphere import read_sphere

    paths = sorted(glob.glob(os.path.join(wav_dir, "**", "*.wav"),
                             recursive=True)
                   + glob.glob(os.path.join(wav_dir, "**", "*.WAV"),
                               recursive=True))
    if max_files:
        paths = paths[:max_files]
    if not paths:
        raise FileNotFoundError(f"no wavs under {wav_dir}")
    rng = np.random.default_rng(seed)
    seg_len = int(seg_len_sec * fs_target)
    pool = []
    for p in paths:
        try:
            fs, x = wavfile.read(p)
        except ValueError:
            # NIST SPHERE under a .wav name, as TIMIT ships its audio
            try:
                fs, x = read_sphere(p)
            except ValueError:
                continue
        if x.ndim > 1:
            x = x[:, 0]
        x = x.astype(np.float32)
        if np.abs(x).max() > 2.0:
            x = x / 32768.0
        if fs != fs_target:
            g = np.gcd(int(fs), int(fs_target))
            x = resample_poly(x, fs_target // g, fs // g)
        if len(x) < seg_len:
            continue
        start = rng.integers(0, len(x) - seg_len + 1)
        pool.append(x[start:start + seg_len].astype(np.float32))
    if not pool:
        raise RuntimeError("no usable speech segments found")
    return np.stack(pool)


def _sector_label(az_deg: float):
    """(sector_id, in-sector angle in (0, 1]) of an azimuth in [0, 360)."""
    sec = int(min(max(np.floor(az_deg / N_SECTOR_DEG), 0), 7))
    return sec, float(min((az_deg - sec * N_SECTOR_DEG + 1e-3)
                          / N_SECTOR_DEG, 1.0))


def _anechoic_labels(synth, meta, b):
    """Sample b's label fields from ``AnechoicSynthesizer.sample_batch_meta``'s
    meta, its sources ordered by sector; the angle is recomputed in
    float64 from the measurement's azimuth."""
    act = np.asarray(meta["active"][b]) > 0.5
    meas = np.asarray(meta["meas"][b]).astype(np.int64)[act]
    meas = meas[np.argsort(synth._sec_np[meas])]
    az = synth._az_np[meas]
    return dict(
        num_sources=int(act.sum()),
        aoa_deg=az.astype(np.float32),
        distance_m=synth._dist_np[meas].astype(np.float32),
        sector_id=synth._sec_np[meas].astype(np.int64),
        sector_angle_norm=np.array([_sector_label(a)[1] for a in az],
                                   np.float32),
        distance_class=synth._dcls_np[meas].astype(np.int64),
    )


def _room_labels(synth, meta, b, scene: str):
    """Sample b's label fields from ``ReverbSynthesizer.sample_batch_meta``'s
    meta (relative azimuths under the sample's head yaw, sources ordered
    by sector); spirit adds the reference's debug fields."""
    act = np.asarray(meta["active"][b]) > 0.5
    spk = np.asarray(meta["speaker_id"][b]).astype(np.int64)[act]
    head = int(np.asarray(meta["head_index"][b]))
    rel = synth._rel_np[head, spk]
    order = np.argsort(rel // N_SECTOR_DEG)
    spk, rel = spk[order], rel[order]
    labels = [_sector_label(a) for a in rel]
    fields = dict(
        num_sources=int(act.sum()),
        aoa_deg=rel.astype(np.float32),
        distance_m=synth._sp_dist_np[spk].astype(np.float32),
        sector_id=np.array([l[0] for l in labels], np.int64),
        sector_angle_norm=np.array([l[1] for l in labels], np.float32),
        distance_class=synth._dcls_np[spk].astype(np.int64),
    )
    if scene == "spirit":
        fields.update(
            speaker_id=spk.astype(np.int64),
            head_yaw_deg=np.float32(synth._yaw_np[head]),
            head_index=np.int64(head),
            dist_protos=DIST_CLASSES.astype(np.float32),
            other_thresh_m=np.float32(OTHER_THRESH_M),
            other_class_id=np.int64(OTHER_CLASS_ID),
            az_offset_deg=np.float32(0.0),
            head_yaw_offset_deg=np.float32(0.0),
        )
    return fields


def write_split(synth, out_dir, name, num: int, seed: int,
                test_thirds: bool, fs: int, scene: str = "anechoic"):
    """Synthesise `num` samples in batches of BATCH from one generator
    seeded with `seed` on the synthesizer's device, and write their wav
    and npz pairs. test_thirds forces one source in the first third, two
    in the second and three in the rest; a batch never straddles a
    third's boundary (with num < 3 no count is forced). Returns the
    batches' label vectors y (num, 56) float32."""
    from scipy.io import wavfile

    label_fn = (_anechoic_labels if scene == "anechoic"
                else lambda s, m, b: _room_labels(s, m, b, scene))
    os.makedirs(out_dir, exist_ok=True)
    third = num // 3
    gen = torch.Generator(device=synth.device).manual_seed(seed)
    ys = []
    i = 0
    while i < num:
        n = min(BATCH, num - i)
        n_src = None
        if test_thirds and third:
            n_src = 1 if i < third else (2 if i < 2 * third else 3)
            boundary = third if i < third else (
                2 * third if i < 2 * third else num)
            n = min(n, boundary - i)
        wavL, wavR, _, y, meta = synth.sample_batch_meta(gen, n, n_src=n_src)
        stereo = torch.stack([wavL, wavR], dim=2).cpu().numpy()
        ys.append(y.cpu().numpy())
        for b in range(n):
            stem = os.path.join(out_dir, f"{name}_{i + b:06d}")
            wavfile.write(stem + ".wav", fs,
                          (np.clip(stereo[b], -1, 1) * 32767).astype(np.int16))
            np.savez(stem + ".npz", audio_path=stem + ".wav",
                     **label_fn(synth, meta, b))
        i += n
    print(f"[{name}] wrote {num} samples -> {out_dir}")
    return np.concatenate(ys) if ys else np.zeros((0, 56), np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene",
                    choices=("anechoic", "room", "auditorium", "spirit"),
                    default="anechoic",
                    help="'room' is a legacy alias for 'auditorium'")
    ap.add_argument("--sofa", default=None, help="HRIR/BRIR SOFA file")
    ap.add_argument("--speech-dir", default=None,
                    help="directory of mono speech wavs")
    ap.add_argument("--out-root", required=True)
    ap.add_argument("--name", default="anechoic_train")
    ap.add_argument("--num", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--test-thirds", action="store_true",
                    help="force 1/3-1/3-1/3 source counts (test splits)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    scene = "auditorium" if args.scene == "room" else args.scene
    fs = 16000
    segments = (collect_speech_pool(args.speech_dir, fs)
                if args.speech_dir else make_test_segments(64))
    synth = build_synthesizer(scene, args.sofa, segments, fs, device=device)
    return write_split(synth, os.path.join(args.out_root, args.name),
                       args.name, args.num, args.seed, args.test_thirds, fs,
                       scene=scene)


if __name__ == "__main__":
    main()
