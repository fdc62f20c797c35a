"""On-device reverberant (BRIR) synthesis: the auditorium and spirit scenes.

Counterpart of ``biear_tpu/data/synth_reverb.py::ReverbSynthesizer``, with
every per-sample step of its ``_one`` batched over the whole batch. A bank
of head-rotation BRIRs (M measurements x 2 ears x E fixed loudspeakers)
and the loudspeakers' (x, y) positions give each (measurement, speaker)
its relative azimuth, sector and in-sector angle. A sample draws a head
measurement, the number of sources, up to that many distinct occupied
sectors (randomised priority among the occupied ones) and one speaker per
chosen sector, picked in turn over the slots and preferring speakers not
used yet; each source is a random 1 s speech segment convolved with the
(head, speaker) BRIR pair as an rFFT product at fft_len = next_pow2(fs +
L - 1), truncated to fs samples (no random crop); the active sources are
summed and scaled to a joint peak of 0.9.

Distance labels use the 5-class rule: the nearest of {0.5, 1, 2, 3} m up
to 3 m, else "other" (class 4), which is folded into the farthest bin of
the 5-way one-hot (the reference's ``other_policy="clamp"``; its label
packing would overflow on class 4 otherwise).

The BRIR spectra are computed once and kept on the device as complex64
(18.9 MB for the built-in spirit bank, 37.7 MB for the auditorium one).
The SOFA readers are copies of ``tools/sofa_io.py``'s, with h5py imported
at first use.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import trace
from ..device import precision_highest, resolve_device
from .labels import DIST_CLASSES, N_DIST_CLASSES, N_SECTORS
from .synth import (finish_batch, host_meta, next_pow2, normalise_peak,
                    one_hot, row_slice, sector_labels, segment_offsets,
                    slice_segments)

# the room scenes' distance labelling: beyond 3 m a source is "other"
OTHER_THRESH_M = 3.0
OTHER_CLASS_ID = 4


def dist_class_5(dist_m: float, other_thresh: float = OTHER_THRESH_M) -> int:
    """0..3 nearest prototype if <= thresh, else 4 ('other')."""
    if dist_m > other_thresh:
        return OTHER_CLASS_ID
    return int(np.argmin(np.abs(DIST_CLASSES - dist_m)))


# the Auditorium3 loudspeakers (generate_auditorium_data.py:56-65)
AUDITORIUM3_SPEAKER_XY = np.array([
    [0.00, 3.97], [4.30, 3.42], [2.20, -1.94],
    [0.00, 1.50], [-0.75, 1.30], [0.75, 1.30],
])

# the Spirit room: 3 loudspeakers at ~2 m (generate_spirit_data.py:57-61)
SPIRIT_SPEAKER_XY = np.array([
    [-1.00, 1.73], [0.00, 2.00], [1.00, 1.73],
])

SCENE_SPEAKER_XY = {
    "auditorium": AUDITORIUM3_SPEAKER_XY,
    "room": AUDITORIUM3_SPEAKER_XY,          # legacy alias
    "spirit": SPIRIT_SPEAKER_XY,
}


def scene_speaker_xy(scene: str, n_emitters: int) -> np.ndarray:
    """The loudspeaker (x, y) table of a named room scene, checked against
    the BRIR bank's emitter count."""
    key = str(scene).lower()
    if key not in SCENE_SPEAKER_XY:
        raise ValueError(f"unknown room scene {scene!r}; "
                         f"known: {sorted(SCENE_SPEAKER_XY)}")
    xy = SCENE_SPEAKER_XY[key]
    if n_emitters > len(xy):
        raise ValueError(
            f"scene {scene!r} defines {len(xy)} loudspeakers but the BRIR "
            f"bank has {n_emitters} emitters: wrong scene for this SOFA?")
    return xy[:n_emitters]


class ReverbSynthesizer:
    """Batched on-device sampler over a head-rotation BRIR bank.

    ir:          (M, 2, E, L) BRIRs at `fs`
    head_yaw:    (M,) head yaw per measurement (deg)
    speaker_xy:  (E, 2) loudspeaker positions (m), head at the origin
    segments:    (P, >= fs) clean speech pool
    device:      where the bank lives and batches are made (the card
                 unless device='cpu')
    """

    def __init__(self, ir, head_yaw, speaker_xy, segments, fs: int = 16000,
                 max_sources: int = 3, num_lags: int = 100,
                 noise_snr_db=None, device=None):
        self.noise_snr_db = (None if noise_snr_db is None
                             else (float(noise_snr_db[0]),
                                   float(noise_snr_db[1])))
        self.device = dev = resolve_device(device)
        ir = np.asarray(ir, np.float32)
        M, R, E, L = ir.shape
        if R != 2:
            raise ValueError(f"BRIRs must have 2 ears, got {R}")
        self.fs = int(fs)
        self.max_sources = int(max_sources)
        self.num_lags = int(num_lags)
        self.ir_len = L
        self.n_speakers = E
        self.n_measurements = M

        speaker_xy = np.asarray(speaker_xy, np.float64)
        sp_dist = np.sqrt((speaker_xy ** 2).sum(1))
        sp_az_world = np.degrees(np.arctan2(speaker_xy[:, 1],
                                            speaker_xy[:, 0])) % 360.0
        yaw = np.asarray(head_yaw, np.float64) % 360.0
        rel = (sp_az_world[None, :] - yaw[:, None]) % 360.0       # (M, E)
        width = 360.0 / N_SECTORS
        sec = np.clip(np.floor(rel / width).astype(np.int64), 0,
                      N_SECTORS - 1)
        norm = np.minimum((rel - sec * width + 1e-3) / width, 1.0)
        dcls = np.array([dist_class_5(d) for d in sp_dist], np.int64)
        onehot_idx = np.minimum(dcls + 1, N_DIST_CLASSES - 1)
        # host tables of sample_batch_meta's readers: head yaw, speaker
        # distance and world azimuth, the relative azimuth per (head,
        # speaker), the true 5-class id ("other" included)
        self._yaw_np = yaw                                        # (M,)
        self._sp_dist_np = sp_dist                                # (E,)
        self._sp_az_world_np = sp_az_world                        # (E,)
        self._rel_np = rel                                        # (M, E)
        self._dcls_np = dcls                                      # (E,)
        self.sector_table = torch.as_tensor(sec, device=dev)      # (M, E)
        self.norm_table = torch.as_tensor(norm.astype(np.float32),
                                          device=dev)             # (M, E)
        self.onehot_idx = torch.as_tensor(onehot_idx, device=dev)  # (E,)

        segments, self.seg_len, self.off_step, self.n_q = segment_offsets(
            segments, self.fs)
        self.fft_len = next_pow2(self.fs + L - 1)
        # the BRIR spectra (M, E, 2, F), one (head, speaker) pick
        # contiguous: numpy's, rounded to complex64 as JAX's bank holds them
        with trace.span("synth.bank", scene="reverb"):
            H = np.fft.rfft(ir.transpose(0, 2, 1, 3), n=self.fft_len)
            self.bank = {"segments": torch.as_tensor(segments, device=dev),
                         "H": torch.as_tensor(H.astype(np.complex64),
                                              device=dev)}

    def scene_batched(self, gen: torch.Generator, batch_size: int,
                      n_src_fixed: int = 0):
        """All per-sample draws -> (head (B,), active (B, MS) bool, sectors,
        speakers, seg_idx, qoff (B, MS) int64). qoff counts segment offsets
        in units of off_step samples."""
        B, MS, E, S = batch_size, self.max_sources, self.n_speakers, N_SECTORS
        dev = self.device
        head = torch.randint(0, self.n_measurements, (B,), generator=gen,
                             device=dev)
        if n_src_fixed > 0:
            n_src = torch.full((B,), n_src_fixed, device=dev)
        else:
            n_src = torch.randint(1, MS + 1, (B,), generator=gen, device=dev)
        spk_sector = self.sector_table[head]                      # (B, E)
        occ = one_hot(spk_sector, S).any(dim=1)                   # (B, S)
        n_eff = torch.minimum(n_src, occ.sum(dim=1))
        prio = (torch.rand((B, S), generator=gen, device=dev)
                + torch.where(occ, 0.0, -1e9))
        sectors = torch.argsort(prio, dim=1, descending=True)[:, :MS]
        active = torch.arange(MS, device=dev)[None, :] < n_eff[:, None]
        # one speaker per chosen sector, in turn over the slots, preferring
        # speakers not used yet
        used = torch.zeros((B, E), dtype=torch.bool, device=dev)
        speakers = []
        for j in range(MS):
            cand = spk_sector == sectors[:, j:j + 1]
            r = torch.rand((B, E), generator=gen, device=dev)
            score = (r + torch.where(cand, 0.0, -1e9)
                     + torch.where(used, -1e3, 0.0))
            s = score.argmax(dim=1)
            used = used | one_hot(s, E)
            speakers.append(s)
        speakers = torch.stack(speakers, dim=1)                   # (B, MS)
        seg_idx = torch.randint(0, self.bank["segments"].shape[0], (B, MS),
                                generator=gen, device=dev)
        qoff = torch.randint(0, self.n_q, (B, MS), generator=gen, device=dev)
        return head, active, sectors, speakers, seg_idx, qoff

    def mix(self, head, active, speakers, seg_idx, qoff) -> torch.Tensor:
        """Segments x (head, speaker) BRIR spectra -> irfft truncated to fs
        -> masked source sum scaled to a joint peak of 0.9: (B, 2, fs)."""
        fs = self.fs
        segs = slice_segments(self.bank["segments"], seg_idx,
                              qoff * self.off_step, fs)           # (B, MS, fs)
        H = self.bank["H"][head[:, None], speakers]          # (B, MS, 2, F)
        with precision_highest():
            X = torch.fft.rfft(segs, n=self.fft_len)
            src = torch.fft.irfft(X[:, :, None] * H, n=self.fft_len)
        return normalise_peak(src[..., :fs], active, 0.9)

    def labels_batched(self, head, active, sectors, speakers) -> torch.Tensor:
        """Scatter-free label build -> (B, 56)."""
        return sector_labels(active, sectors,
                             self.norm_table[head[:, None], speakers],
                             self.onehot_idx[speakers])

    def assemble(self, gen: torch.Generator, batch_size: int,
                 n_src_fixed: int = 0, with_meta: bool = False, rows=None):
        """One batch, or `rows` (start, stop) of it from the whole batch's
        draws, as ``AnechoicSynthesizer.assemble``."""
        sl = row_slice(rows)
        head, active, sectors, speakers, seg_idx, qoff = (
            t[sl] for t in self.scene_batched(gen, batch_size, n_src_fixed))
        y_lr = self.mix(head, active, speakers, seg_idx, qoff)
        out = finish_batch(gen, y_lr, self.noise_snr_db, self.fs,
                           self.num_lags,
                           self.labels_batched(head, active, sectors,
                                               speakers),
                           batch_size, rows)
        if not with_meta:
            return out
        return (*out, host_meta(head_index=head, speaker_id=speakers,
                                sector_id=sectors, active=active))

    def sample_batch(self, gen: torch.Generator, batch_size: int,
                     n_src: int | None = None, rows=None):
        """(wavL, wavR, x3, y) with shapes (B, fs) x2, (B, num_lags),
        (B, 56); n_src and rows as in ``AnechoicSynthesizer.sample_batch``
        (a head with fewer occupied sectors gives fewer sources)."""
        with torch.no_grad():
            return self.assemble(gen, batch_size,
                                 0 if n_src is None else int(n_src),
                                 rows=rows)

    def sample_batch_meta(self, gen: torch.Generator, batch_size: int,
                          n_src: int | None = None):
        """sample_batch's batch plus the scene of each sample:
        {"head_index" (B,), "speaker_id", "sector_id", "active" (B, MS)},
        float32 numpy on the host, as JAX's meta."""
        with torch.no_grad():
            return self.assemble(gen, batch_size,
                                 0 if n_src is None else int(n_src),
                                 with_meta=True)

    def batch_fn(self, batch_size: int, n_src: int | None = None,
                 rows=None):
        """gen -> batch closure for the fused train chunk."""
        return functools.partial(self.sample_batch, batch_size=batch_size,
                                 n_src=n_src, rows=rows)


def make_test_brir_bank(n_yaw: int = 24, ir_len: int = 1200, seed: int = 0,
                        speaker_xy=None, fs: int = 16000):
    """A synthetic room bank: a direct path with azimuth-dependent ITD and
    ILD plus an exponentially decaying diffuse tail. Numpy; the same arrays
    as the JAX package's fixture for the same arguments."""
    rng = np.random.default_rng(seed)
    if speaker_xy is None:
        speaker_xy = AUDITORIUM3_SPEAKER_XY
    speaker_xy = np.asarray(speaker_xy, np.float64)
    E = len(speaker_xy)
    yaw = np.linspace(-90.0, 90.0, n_yaw) % 360.0
    az_world = np.degrees(np.arctan2(speaker_xy[:, 1],
                                     speaker_xy[:, 0])) % 360.0
    dist = np.sqrt((speaker_xy ** 2).sum(1))

    ir = np.zeros((n_yaw, 2, E, ir_len), np.float32)
    for mi in range(n_yaw):
        for e in range(E):
            rel = np.deg2rad((az_world[e] - yaw[mi]) % 360.0)
            itd = 0.0007 * np.sin(rel)
            base = 10 + int(dist[e] * fs / 343.0) % 40
            dl = base + max(0, int(round(-itd * fs)))
            dr = base + max(0, int(round(itd * fs)))
            gl = (1.0 + 0.4 * np.sin(rel)) / (1.0 + dist[e])
            gr = (1.0 - 0.4 * np.sin(rel)) / (1.0 + dist[e])
            ir[mi, 0, e, dl:dl + 16] = gl * np.exp(-np.arange(16) / 3.0)
            ir[mi, 1, e, dr:dr + 16] = gr * np.exp(-np.arange(16) / 3.0)
            tail_start = base + 40
            tail = rng.standard_normal(ir_len - tail_start) * np.exp(
                -np.arange(ir_len - tail_start) / (0.08 * fs))
            ir[mi, :, e, tail_start:] += 0.05 * tail / (1.0 + dist[e])
    return ir, yaw, speaker_xy


# ------------- SOFA BRIR banks (copies of tools/sofa_io.py) -------------

def _vec_to_az_deg(v):
    v = np.asarray(v, np.float64).reshape(-1)
    return float(np.degrees(np.arctan2(v[1], v[0])) % 360.0)


def extract_head_yaw(view, source_pos, M: int):
    """Head yaw (deg) per measurement, the reference's 4-tier parser
    (generate_auditorium_data.py:133-181), in priority order:

      1) ListenerView rows that look like unit-ish vectors (median norm in
         (0.5, 2)) -> atan2 azimuth;
      2) ListenerView[:, 0] that looks like degrees (within [-360, 360]);
      3) SourcePosition[:, 0] degrees, else SourcePosition vector rows;
      4) the fallback linspace(-90, 90) % 360.

    Returns (yaw (M,) float64 in [0, 360), the tier's tag)."""
    lv = None if view is None else np.squeeze(np.asarray(view, np.float64))
    if (lv is not None and lv.ndim == 2 and lv.shape[0] == M
            and lv.shape[1] >= 2):
        if lv.shape[1] >= 3:
            norms = np.linalg.norm(lv[:, :3], axis=1)
            if 0.5 < np.median(norms) < 2.0:
                yaw = np.array([_vec_to_az_deg(lv[m, :3]) for m in range(M)])
                return yaw, "ListenerView(vector)->az"
        if -360 <= np.nanmin(lv[:, 0]) and np.nanmax(lv[:, 0]) <= 360:
            return lv[:, 0] % 360.0, "ListenerView[:,0](deg)"
    sp = (None if source_pos is None
          else np.squeeze(np.asarray(source_pos, np.float64)))
    if (sp is not None and sp.ndim == 2 and sp.shape[0] == M
            and sp.shape[1] >= 1):
        if -360 <= np.nanmin(sp[:, 0]) and np.nanmax(sp[:, 0]) <= 360:
            return sp[:, 0] % 360.0, "SourcePosition[:,0](deg)"
        if sp.shape[1] >= 3:
            norms = np.linalg.norm(sp[:, :3], axis=1)
            if 0.5 < np.median(norms) < 2.0:
                yaw = np.array([_vec_to_az_deg(sp[m, :3]) for m in range(M)])
                return yaw, "SourcePosition(vector)->az"
    return (np.linspace(-90.0, 90.0, M) % 360.0), "fallback linspace(-90,90)"


def load_sofa_brir(path: str, fs_target: int = 16000):
    """A multi-emitter BRIR SOFA file (Data.IR (M, 2, E, N)), polyphase-
    resampled to fs_target -> (ir (M, 2, E, L) float32, ListenerView or
    None, SourcePosition or None)."""
    import h5py
    from scipy.signal import resample_poly

    with h5py.File(path, "r") as f:
        ir = np.asarray(f["Data.IR"])
        fs = float(np.asarray(f["Data.SamplingRate"]).reshape(-1)[0])
        pos = (np.asarray(f["SourcePosition"]) if "SourcePosition" in f
               else None)
        view = (np.asarray(f["ListenerView"]) if "ListenerView" in f
                else None)
    if fs != fs_target:
        g = np.gcd(int(fs), int(fs_target))
        ir = resample_poly(ir, int(fs_target // g), int(fs // g), axis=-1)
    return ir.astype(np.float32), view, pos
