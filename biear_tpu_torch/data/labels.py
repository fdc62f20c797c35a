"""Label construction: the 56-dim per-sample target vector.

A copy of ``biear_tpu/data/labels.py`` (the port imports nothing of the
JAX package), numpy only. Layout: 8 sectors x [sound_presence,
angle_norm, 5-way one-hot distance], where distance index 0 = no source
and 1..4 are the classes {0.5, 1, 2, 3} m shifted by +1.
"""

from __future__ import annotations

import numpy as np

N_SECTORS = 8
N_DIST_CLASSES = 5
DIST_CLASSES = np.array([0.5, 1.0, 2.0, 3.0], dtype=np.float64)


def aoa_to_sector_label(az_deg: float, n_sectors: int = N_SECTORS):
    """AoA (deg) -> (sector_id, normalised in-sector angle in (0, 1]),
    with the +1e-3 epsilon and the cap at 1.0."""
    az = az_deg % 360.0
    width = 360.0 / n_sectors
    sector_id = int(np.floor(az / width))
    norm = (az - sector_id * width + 1e-3) / width
    return sector_id, min(norm, 1.0)


def distance_to_class_index(dist_m: float) -> int:
    """Nearest-prototype class over {0.5, 1, 2, 3} m."""
    return int(np.argmin(np.abs(DIST_CLASSES - dist_m)))


def pack_label(sector_ids, angle_norms, dist_classes, num_sources: int):
    """Vector y (56,) from per-source arrays. dist_classes are the raw
    0..3 indices, shifted by +1 into the 5-way one-hot here; sector ids
    outside [0, N_SECTORS) are skipped."""
    sound = np.zeros(N_SECTORS, np.float32)
    angle = np.zeros(N_SECTORS, np.float32)
    onehot = np.zeros((N_SECTORS, N_DIST_CLASSES), np.float32)
    onehot[:, 0] = 1.0
    for k in range(int(num_sources)):
        sid = int(sector_ids[k])
        if sid < 0 or sid >= N_SECTORS:
            continue
        sound[sid] = 1.0
        angle[sid] = float(angle_norms[k])
        onehot[sid, :] = 0.0
        onehot[sid, int(dist_classes[k]) + 1] = 1.0
    y = np.concatenate(
        [np.stack([sound, angle], axis=1), onehot], axis=1)
    return y.reshape(-1).astype(np.float32)


def build_label_from_npz_dict(d) -> np.ndarray:
    """An npz label dict (sector_id, sector_angle_norm, distance_class,
    num_sources) -> y (56,)."""
    return pack_label(
        np.asarray(d["sector_id"], np.int64),
        np.asarray(d["sector_angle_norm"], np.float32),
        np.asarray(d["distance_class"], np.int64),
        int(d["num_sources"]),
    )


def split_y_matrix(y_mat: np.ndarray):
    """The reference's per-sector output split: y (N, 56) -> 24 arrays,
    per sector [sound (N,), angle (N,), dist (N, 5)]."""
    y_mat = np.asarray(y_mat)
    out = []
    for k in range(N_SECTORS):
        base = 7 * k
        out.append(y_mat[:, base])
        out.append(y_mat[:, base + 1])
        out.append(y_mat[:, base + 2:base + 7])
    return out
