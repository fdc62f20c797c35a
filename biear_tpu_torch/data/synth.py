"""On-device anechoic binaural synthesis, the fast path.

Counterpart of ``biear_tpu/data/synth.py::AnechoicSynthesizer`` where its
``_fast`` geometry holds (fs a multiple of 128, HRIRs of at most 257
taps, at most 8 block offsets per segment): every batch is one scene draw,
one HRIR mix through the window-gather kernels, the CC feature and the
labels, all on the synthesizer's device.

Scene (the reference's anechoic generator): n_src ~ Uniform{1, 2, 3} (or
fixed), each source in a distinct 45-degree sector, its HRIR measurement
drawn uniformly within the sector; a 1 s speech segment convolved with the
measurement's HRIR pair, a random crop of the convolution, sources summed,
joint peak-normalisation to +-1; labels per sector [presence, in-sector
normalised angle, 5-way distance one-hot].

The HRIR convolution is one block-Toeplitz product per (sample, source):
``KB[m, jj, e*128 + i] = ir_rev[m, e, jj - i]`` against the halo frames of
a sample-granular window of the padded pool. Mix policies:

  * ``mix_dtype="bfloat16"`` (production): the fused CUDA kernel
    ``gather_mix_kb`` (window rounded to bf16, f32 sums);
  * ``mix_dtype="float32"`` (parity): the CUDA window gather
    ``gather_windows``, the halo framing, then one batched f32 product
    (TF32 off), the op JAX leaves to XLA.

Random draws come from an explicit ``torch.Generator`` on the
synthesizer's device. Geometries where the JAX package takes its
per-sample path raise NotImplementedError (see ROADMAP.md).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import no_tf32, resolve_device
from ..ops.window_gather import (WIN, frame_windows, gather_mix_kb,
                                 gather_windows, pad_pool_for_windows)
from ..ops.xcorr import cross_correlation_feature
from .labels import DIST_CLASSES, N_DIST_CLASSES, N_SECTORS


def add_diffuse_noise(gen: torch.Generator, y: torch.Tensor, snr_range):
    """Mix ear-uncorrelated Gaussian noise into y (B, 2, fs) at a
    per-sample SNR ~ U[lo, hi] dB, then re-normalise the joint peak."""
    lo, hi = snr_range
    B = y.shape[0]
    snr_db = lo + (hi - lo) * torch.rand((B, 1, 1), generator=gen,
                                         device=y.device)
    sig_rms = torch.sqrt(torch.mean(y * y, dim=(1, 2), keepdim=True) + 1e-12)
    noise = torch.randn(y.shape, generator=gen, device=y.device,
                        dtype=y.dtype)
    y = y + noise * sig_rms * 10.0 ** (-snr_db / 20.0)
    peak = torch.clamp(y.abs().amax(dim=(1, 2), keepdim=True), min=1e-8)
    return y / peak


class AnechoicSynthesizer:
    """Batched on-device sampler over an HRIR bank and a speech pool.

    ir:        (M, 2, L) float32 HRIR bank (already at `fs`)
    az_deg:    (M,) source azimuths in [0, 360)
    dist_m:    (M,) source distances (metres)
    segments:  (P, seg_len >= fs) float32 pool of clean speech
    device:    where the bank lives and batches are made (the card unless
               device='cpu')
    """

    def __init__(self, ir, az_deg, dist_m, segments, fs: int = 16000,
                 max_sources: int = 3, n_sectors: int = N_SECTORS,
                 num_lags: int = 100, noise_snr_db=None,
                 mix_dtype: str = "float32", device=None):
        self.noise_snr_db = (None if noise_snr_db is None
                             else (float(noise_snr_db[0]),
                                   float(noise_snr_db[1])))
        self.mix_dtype = str(mix_dtype).lower()
        if self.mix_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"mix_dtype must be 'float32' or 'bfloat16', "
                             f"got {mix_dtype!r}")
        self.device = resolve_device(device)
        ir = np.asarray(ir, np.float32)
        az = np.asarray(az_deg, np.float64) % 360.0
        dist = np.asarray(dist_m, np.float64)
        self.fs = int(fs)
        self.max_sources = int(max_sources)
        self.n_sectors = int(n_sectors)
        self.num_lags = int(num_lags)
        M, _, L = ir.shape
        self.ir_len = L

        # per-sector measurement tables, padded square with the last entry
        width = 360.0 / n_sectors
        sec_of = np.floor(az / width).astype(np.int64) % n_sectors
        groups = [np.nonzero(sec_of == s)[0] for s in range(n_sectors)]
        for s, g in enumerate(groups):
            if len(g) == 0:
                raise ValueError(f"no HRIR measurements in sector {s}")
        kmax = max(len(g) for g in groups)
        sector_table = np.stack([np.pad(g, (0, kmax - len(g)), mode="edge")
                                 for g in groups])               # (S, kmax)

        # per-measurement labels
        in_sector = az - sec_of * width
        norm = np.minimum((in_sector + 1e-3) / width, 1.0)
        dcls = np.argmin(np.abs(DIST_CLASSES[None, :] - dist[:, None]), axis=1)

        segments = np.asarray(segments, np.float32)
        self.seg_len = segments.shape[1]
        if self.seg_len < self.fs:
            raise ValueError("segments must be at least 1 s long")
        aligned = self.fs % 128 == 0
        if aligned and segments.shape[1] % 128:
            segments = np.pad(segments,
                              ((0, 0), (0, 128 - segments.shape[1] % 128)))
        self.n_q = (self.seg_len - self.fs) // 128 + 1 if aligned else 0
        kb_bytes = M * (128 + L - 1) * 256 * 4
        fast = (aligned and L <= 257 and 1 <= self.n_q <= 8
                and self.fs + L - 1 <= WIN and kb_bytes <= 768 * 2**20)
        if not fast:
            raise NotImplementedError(
                "this geometry takes the JAX package's per-sample synthesis "
                "path (fs % 128, long HRIRs or long segments), which is not "
                "ported yet: see ROADMAP.md")

        # pool rows: segment x 128-block offset, zero-guarded for the crop
        NPn = segments.shape[0]
        rows = np.zeros((NPn * self.n_q, self.fs), np.float32)
        for q in range(self.n_q):
            rows[q::self.n_q] = segments[:, q * 128:q * 128 + self.fs]
        # block-Toeplitz kernel bank, rows zero-padded to a multiple of 128
        ir_rev = np.ascontiguousarray(ir[:, :, ::-1])
        ncol = 128 * (-(-(128 + L - 1) // 128))
        d = np.arange(ncol)[:, None] - np.arange(128)[None, :]
        KB = ir_rev[:, :, d.clip(0, L - 1)] * ((d >= 0) & (d < L))
        KB = KB.transpose(0, 2, 1, 3).reshape(M, ncol, 256).astype(np.float32)
        dev = self.device
        kb = torch.as_tensor(KB, device=dev)
        self.bank = {
            "segments": torch.as_tensor(segments, device=dev),
            "meas_norm": torch.as_tensor(norm.astype(np.float32), device=dev),
            "meas_dcls": torch.as_tensor(dcls.astype(np.float32), device=dev),
            "pool3": torch.as_tensor(pad_pool_for_windows(rows, L - 1, L - 1),
                                     device=dev),
            # torch's bf16 cast rounds to nearest even, as JAX's astype
            "KB": kb.to(torch.bfloat16) if self.mix_dtype == "bfloat16"
            else kb,
        }
        self.sector_table = torch.as_tensor(sector_table, dtype=torch.long,
                                            device=dev)
        self.sector_counts = torch.as_tensor([len(g) for g in groups],
                                             device=dev)

    # ---------------- the batched fast path ----------------

    def scene_batched(self, gen: torch.Generator, batch_size: int,
                      n_src_fixed: int = 0):
        """All per-sample draws, one call per variable -> (active (B, MS)
        bool, sectors, meas, seg_idx, qoff, crop (B, MS) int64). Distinct
        sectors come from an argsort of iid uniforms (a uniformly random
        permutation)."""
        B, MS, S = batch_size, self.max_sources, self.n_sectors
        dev = self.device
        if n_src_fixed > 0:
            n_src = torch.full((B,), n_src_fixed, device=dev)
        else:
            n_src = torch.randint(1, MS + 1, (B,), generator=gen, device=dev)
        active = torch.arange(MS, device=dev)[None, :] < n_src[:, None]
        u8 = torch.rand((B, S), generator=gen, device=dev)
        sectors = torch.argsort(u8, dim=1)[:, :MS]
        u = torch.rand((B, MS), generator=gen, device=dev)
        counts = self.sector_counts[sectors]
        kslot = torch.minimum((u * counts).long(), counts - 1)
        meas = self.sector_table[sectors, kslot]
        n_segs = self.bank["segments"].shape[0]
        seg_idx = torch.randint(0, n_segs, (B, MS), generator=gen, device=dev)
        qoff = torch.randint(0, self.n_q, (B, MS), generator=gen, device=dev)
        crop = torch.randint(0, self.ir_len, (B, MS), generator=gen,
                             device=dev)
        return active, sectors, meas, seg_idx, qoff, crop

    def mix_fast(self, active, meas, seg_idx, qoff, crop) -> torch.Tensor:
        """windows -> block-Toeplitz HRIR conv -> masked source sum ->
        joint peak normalisation: (B, 2, fs).

        out[b, e, t] = sum_s active * sum_k seg[t + c - k] ir[m, e, k], with
        zero-guard rows giving the zero-padded conv edges exactly."""
        B, MS = active.shape
        fs = self.fs
        X, nf = B * MS, fs // 128
        bank = self.bank
        rows = (seg_idx * self.n_q + qoff).reshape(X)
        crop, meas = crop.reshape(X), meas.reshape(X)
        if self.mix_dtype == "bfloat16":
            out = gather_mix_kb(bank["pool3"], rows, crop, meas, bank["KB"],
                                nf)
        else:
            kb = bank["KB"]
            fw = frame_windows(gather_windows(bank["pool3"], rows, crop), nf,
                               kb.shape[1])
            with no_tf32():
                out = torch.matmul(fw, kb[meas])
        out = out.reshape(B, MS, nf, 2, 128)
        out = out * active.to(out.dtype)[:, :, None, None, None]
        y = out.sum(dim=1).transpose(1, 2).reshape(B, 2, fs)
        peak = torch.clamp(y.abs().amax(dim=(1, 2), keepdim=True), min=1e-8)
        return y / peak

    def labels_batched(self, active, sectors, meas) -> torch.Tensor:
        """Scatter-free label build -> (B, S * (2 + C))."""
        S, C = self.n_sectors, N_DIST_CLASSES
        maskf = active.float()
        sec1 = F.one_hot(sectors, S).float()                   # (B, MS, S)
        sound = torch.einsum("bms,bm->bs", sec1, maskf)
        angle = torch.einsum("bms,bm->bs", sec1,
                             self.bank["meas_norm"][meas] * maskf)
        base = torch.zeros((S, C), device=maskf.device)
        base[:, 0] = 1.0
        dcls = self.bank["meas_dcls"][meas].long()
        rows = F.one_hot(torch.where(active, dcls + 1, 0), C).float()
        covered = sec1.sum(dim=1)                              # (B, S)
        onehot = (base[None] * (1.0 - covered)[:, :, None]
                  + torch.einsum("bms,bmc->bsc", sec1, rows))
        B = active.shape[0]
        return torch.cat([sound[..., None], angle[..., None], onehot],
                         dim=2).reshape(B, -1)

    def assemble(self, gen: torch.Generator, batch_size: int,
                 n_src_fixed: int = 0):
        """One batch (wavL, wavR, x3, y): scene -> mix -> optional noise ->
        CC feature -> labels."""
        active, sectors, meas, seg_idx, qoff, crop = self.scene_batched(
            gen, batch_size, n_src_fixed)
        y_lr = self.mix_fast(active, meas, seg_idx, qoff, crop)
        if self.noise_snr_db is not None:
            y_lr = add_diffuse_noise(gen, y_lr, self.noise_snr_db)
        wavL, wavR = y_lr[:, 0], y_lr[:, 1]
        x3 = cross_correlation_feature(wavL, wavR, self.fs,
                                       num_lags=self.num_lags)
        y = self.labels_batched(active, sectors, meas)
        return wavL, wavR, x3, y

    def sample_batch(self, gen: torch.Generator, batch_size: int,
                     n_src: int | None = None):
        """(wavL, wavR, x3, y) with shapes (B, fs) x2, (B, num_lags),
        (B, 56). n_src=None -> Uniform{1..max_sources} per sample; n_src=k
        -> that many sources in every sample."""
        with torch.no_grad():
            return self.assemble(gen, batch_size,
                                 0 if n_src is None else int(n_src))

    def batch_fn(self, batch_size: int, n_src: int | None = None):
        """gen -> batch closure for the fused train chunk: the same draws
        as sample_batch for the same generator state."""
        return functools.partial(self.sample_batch, batch_size=batch_size,
                                 n_src=n_src)


# ---------------- fixtures for tests and benchmarks ----------------

def make_test_hrir_bank(m_per_sector: int = 4, ir_len: int = 256,
                        seed: int = 0, fs: int = 16000):
    """A synthetic HRIR bank: per-azimuth interaural delay (up to ~0.7 ms)
    and level difference, exponentially decaying tails. Numpy; the same
    arrays as the JAX package's fixture for the same arguments."""
    rng = np.random.default_rng(seed)
    M = 8 * m_per_sector
    az = (np.arange(M) + 0.5) * (360.0 / M)
    dist = DIST_CLASSES[np.arange(M) % 4]
    ir = np.zeros((M, 2, ir_len), np.float32)
    for m in range(M):
        theta = np.deg2rad(az[m])
        itd = 0.0007 * np.sin(theta)                 # seconds, +: right later
        base_delay = 8
        dl = base_delay + max(0, int(round(-itd * fs)))
        dr = base_delay + max(0, int(round(itd * fs)))
        gl = 1.0 + 0.4 * np.sin(theta)
        gr = 1.0 - 0.4 * np.sin(theta)
        tail = np.exp(-np.arange(24) / 4.0)
        ir[m, 0, dl:dl + 24] = gl * tail * rng.uniform(0.7, 1.0, 24)
        ir[m, 1, dr:dr + 24] = gr * tail * rng.uniform(0.7, 1.0, 24)
    return ir, az, dist


def make_test_segments(n: int = 16, seg_len: int = 16000, seed: int = 1):
    """Speech-like pool: modulated noise, peak-normalised (numpy)."""
    rng = np.random.default_rng(seed)
    t = np.arange(seg_len) / 16000.0
    segs = []
    for _ in range(n):
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 6) * t
                                + rng.uniform(0, 6)))
        x = env * rng.standard_normal(seg_len)
        segs.append((x / (np.abs(x).max() + 1e-8)).astype(np.float32))
    return np.stack(segs)


# ---------------- scene -> synthesizer (the runner's entry) ----------------

def load_sofa_hrir(path: str, fs_target: int = 16000):
    """An anechoic HRIR SOFA file (HDF5) -> (ir (M, 2, L) float32 at
    fs_target, az_deg (M,), dist_m (M,)): Data.IR, Data.SamplingRate and
    SourcePosition [azimuth, elevation, distance], polyphase-resampled by
    the rates' gcd. A copy of ``tools/sofa_io.py::load_sofa_hrir``; h5py is
    imported here, at first use."""
    import h5py
    from scipy.signal import resample_poly

    with h5py.File(path, "r") as f:
        ir = np.asarray(f["Data.IR"])
        fs = float(np.asarray(f["Data.SamplingRate"]).reshape(-1)[0])
        pos = np.asarray(f["SourcePosition"])
    if ir.ndim != 3:
        raise ValueError(f"expected anechoic (M, R, N) IR, got {ir.shape}")
    az = pos[:, 0] % 360.0
    dist = pos[:, 2]
    if fs != fs_target:
        g = np.gcd(int(fs), int(fs_target))
        ir = resample_poly(ir, int(fs_target // g), int(fs // g), axis=-1)
    return (ir.astype(np.float32), az.astype(np.float64),
            dist.astype(np.float64))


def build_synthesizer(scene: str, sofa: str | None, segments, fs: int,
                      num_lags: int = 100, device=None):
    """Scene -> synthesizer on `device`, as
    ``tools/generate_binaural_data.py::build_synthesizer`` builds it for
    ``train_biear.py`` (no noise, the f32 mix): the anechoic scene over a
    SOFA HRIR bank, or the built-in test bank without one. num_lags is the
    CC feature's width (the model's n_bands). The reverberant scenes are
    not ported."""
    if scene != "anechoic":
        raise NotImplementedError(
            f"scene {scene!r}: the reverberant synthesizer (auditorium, "
            "spirit) is not ported yet (ROADMAP.md, Queue 2 item 5)")
    if sofa:
        ir, az, dist = load_sofa_hrir(sofa, fs)
    else:
        ir, az, dist = make_test_hrir_bank()
    return AnechoicSynthesizer(ir, az, dist, segments, fs=fs,
                               num_lags=num_lags, device=device)
