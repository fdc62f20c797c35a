"""On-device anechoic binaural synthesis.

Counterpart of ``biear_tpu/data/synth.py::AnechoicSynthesizer``: every
batch is one batched scene draw, one HRIR mix, the CC feature and the
labels, all on the synthesizer's device.

Scene (the reference's anechoic generator): n_src ~ Uniform{1, 2, 3} (or
fixed), each source in a distinct 45-degree sector, its HRIR measurement
drawn uniformly within the sector; a 1 s speech segment convolved with the
measurement's HRIR pair, a random crop in [0, L - 1] of the convolution,
sources summed, joint peak-normalisation to +-1; labels per sector
[presence, in-sector normalised angle, 5-way distance one-hot].

The fast path (fs a multiple of 128, HRIRs of at most 257 taps, at most 8
block offsets per segment) runs the convolution as one block-Toeplitz
product per (sample, source):
``KB[m, jj, e*128 + i] = ir_rev[m, e, jj - i]`` against the halo frames of
a sample-granular window of the padded pool. Mix policies:

  * ``mix_dtype="bfloat16"`` (production): the fused CUDA kernel
    ``gather_mix_kb`` (window rounded to bf16, f32 sums);
  * ``mix_dtype="float32"`` (parity): the CUDA window gather
    ``gather_windows``, the halo framing, then one batched f32 product
    (TF32 off), the op JAX leaves to XLA.

Off the fast path (JAX's per-sample ``_one``) the same batched draws feed
the general mix (``mix_general``): the segments are sliced at 128-sample
block offsets when fs % 128 == 0 and at sample offsets otherwise, then
convolved in f32 as one batched rFFT product against the HRIRs' spectra
(numpy's, rounded to complex64, at the next power of two >= fs + L - 1);
the crop, the source sum and the peak normalisation follow. The mix
policy does not apply there.

Random draws come from an explicit ``torch.Generator`` on the
synthesizer's device. ``rows=(start, stop)`` makes rows start..stop of a
batch: every draw (scene and noise) is made for the whole batch, then
only those rows are mixed, noised, correlated and labelled, so the rows
of a batch do not depend on how a mesh splits it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import trace
from ..device import precision_highest, resolve_device
from ..ops.window_gather import (WIN, frame_windows, gather_mix_kb,
                                 gather_windows, pad_pool_for_windows)
from ..ops.xcorr import cross_correlation_feature
from .labels import DIST_CLASSES, N_DIST_CLASSES, N_SECTORS


def row_slice(rows) -> slice:
    """(start, stop) -> slice; None -> every row."""
    return slice(None) if rows is None else slice(*rows)


def add_diffuse_noise(gen: torch.Generator, y: torch.Tensor, snr_range,
                      batch_size: int | None = None, rows=None):
    """Mix ear-uncorrelated Gaussian noise into y (B, 2, fs) at a
    per-sample SNR ~ U[lo, hi] dB, then re-normalise the joint peak. With
    `rows`, y holds those rows of a batch of `batch_size`, whose draws are
    all made."""
    lo, hi = snr_range
    B = y.shape[0] if batch_size is None else batch_size
    sl = row_slice(rows)
    snr_db = lo + (hi - lo) * torch.rand((B, 1, 1), generator=gen,
                                         device=y.device)[sl]
    sig_rms = torch.sqrt(torch.mean(y * y, dim=(1, 2), keepdim=True) + 1e-12)
    noise = torch.randn((B, *y.shape[1:]), generator=gen, device=y.device,
                        dtype=y.dtype)[sl]
    y = y + noise * sig_rms * 10.0 ** (-snr_db / 20.0)
    peak = torch.clamp(y.abs().amax(dim=(1, 2), keepdim=True), min=1e-8)
    return y / peak


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def segment_offsets(segments, fs: int):
    """(segments padded to whole 128-sample blocks when fs % 128 == 0,
    their original length, the offset step (128, or 1 sample otherwise),
    the number of offsets that keep a 1 s slice inside the original
    length)."""
    segments = np.asarray(segments, np.float32)
    seg_len = segments.shape[1]
    if seg_len < fs:
        raise ValueError("segments must be at least 1 s long")
    step = 128 if fs % 128 == 0 else 1
    if step == 128 and seg_len % 128:
        segments = np.pad(segments, ((0, 0), (0, 128 - seg_len % 128)))
    return segments, seg_len, step, (seg_len - fs) // step + 1


def slice_segments(segments: torch.Tensor, seg_idx: torch.Tensor,
                   start: torch.Tensor, fs: int) -> torch.Tensor:
    """segments[seg_idx, start : start + fs] for every index: (..., fs)."""
    t = torch.arange(fs, device=segments.device)
    return segments[seg_idx[..., None], start[..., None] + t]


def normalise_peak(src: torch.Tensor, active: torch.Tensor,
                   level: float) -> torch.Tensor:
    """Sources (B, MS, 2, fs) -> their active sum scaled to a joint peak of
    `level` (B, 2, fs)."""
    y = (src * active.to(src.dtype)[:, :, None, None]).sum(dim=1)
    peak = torch.clamp(y.abs().amax(dim=(1, 2), keepdim=True), min=1e-8)
    return level * y / peak


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n).bool()`` for indices in [0, n) as one
    comparison: ``F.one_hot`` checks the range with a host read of the
    indices' min and max on the CPU, a sync that a captured step must not
    make."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def sector_labels(active, sectors, angle_norm, dist_idx,
                  n_sectors: int = N_SECTORS) -> torch.Tensor:
    """Scatter-free labels (B, S * (2 + C)) from each slot's distinct
    sector, in-sector normalised angle and distance one-hot index (class
    + 1; 0 is 'no source'); inactive slots leave their sector empty."""
    S, C = n_sectors, N_DIST_CLASSES
    maskf = active.float()
    sec1 = one_hot(sectors, S).float()                     # (B, MS, S)
    sound = torch.einsum("bms,bm->bs", sec1, maskf)
    angle = torch.einsum("bms,bm->bs", sec1, angle_norm * maskf)
    # (S, C): class 0 ('no source') in every sector
    base = one_hot(torch.zeros(S, dtype=torch.long, device=maskf.device),
                   C).float()
    rows = one_hot(torch.where(active, dist_idx, 0), C).float()
    covered = sec1.sum(dim=1)                              # (B, S)
    onehot = (base[None] * (1.0 - covered)[:, :, None]
              + torch.einsum("bms,bmc->bsc", sec1, rows))
    B = active.shape[0]
    return torch.cat([sound[..., None], angle[..., None], onehot],
                     dim=2).reshape(B, -1)


def host_meta(**draws) -> dict:
    """Scene draws (tensors on any device) -> float32 numpy arrays, the
    dtype of JAX's sampler metadata."""
    return {k: v.float().cpu().numpy() for k, v in draws.items()}


def finish_batch(gen: torch.Generator, y_lr: torch.Tensor, noise_snr_db,
                 fs: int, num_lags: int, y: torch.Tensor,
                 batch_size: int | None = None, rows=None):
    """Mixed ears (B, 2, fs) and labels -> (wavL, wavR, x3, y): the
    optional diffuse noise, then the CC feature (`rows` of a batch of
    `batch_size` as in ``add_diffuse_noise``)."""
    if noise_snr_db is not None:
        y_lr = add_diffuse_noise(gen, y_lr, noise_snr_db, batch_size, rows)
    wavL, wavR = y_lr[:, 0], y_lr[:, 1]
    x3 = cross_correlation_feature(wavL, wavR, fs, num_lags=num_lags)
    return wavL, wavR, x3, y


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
        # host tables of sample_batch_meta's readers (the offline writer's
        # continuous azimuths and real distances)
        self._az_np = az                                          # (M,)
        self._dist_np = dist                                      # (M,)
        self._dcls_np = dcls.astype(np.int64)                     # (M,)
        self._sec_np = sec_of.astype(np.int64)                    # (M,)

        segments, self.seg_len, self.off_step, self.n_q = segment_offsets(
            segments, self.fs)
        kb_bytes = M * (128 + L - 1) * 256 * 4
        self.fast = (self.off_step == 128 and L <= 257 and self.n_q <= 8
                     and self.fs + L - 1 <= WIN and kb_bytes <= 768 * 2**20)
        # the host bank: numpy tables (the Toeplitz KB on the fast path, the
        # spectra otherwise) built and copied to the device
        with trace.span("synth.bank", scene="anechoic"):
            dev = self.device
            self.bank = {
                "segments": torch.as_tensor(segments, device=dev),
                "meas_norm": torch.as_tensor(norm.astype(np.float32),
                                             device=dev),
                "meas_dcls": torch.as_tensor(dcls.astype(np.float32),
                                             device=dev),
            }
            self.sector_table = torch.as_tensor(sector_table,
                                                dtype=torch.long, device=dev)
            self.sector_counts = torch.as_tensor([len(g) for g in groups],
                                                 device=dev)
            if not self.fast:
                # the general path: the HRIRs' spectra for the FFT product,
                # numpy's rounded to complex64 as JAX's bank
                self.fft_len = next_pow2(self.fs + L - 1)
                self.bank["H"] = torch.as_tensor(
                    np.fft.rfft(ir, n=self.fft_len).astype(np.complex64),
                    device=dev)
                return

            # pool rows: segment x 128-block offset, zero-guarded for the
            # crop
            NPn = segments.shape[0]
            rows = np.zeros((NPn * self.n_q, self.fs), np.float32)
            for q in range(self.n_q):
                rows[q::self.n_q] = segments[:, q * 128:q * 128 + self.fs]
            # block-Toeplitz kernel bank, rows zero-padded to a multiple of
            # 128
            ir_rev = np.ascontiguousarray(ir[:, :, ::-1])
            ncol = 128 * (-(-(128 + L - 1) // 128))
            d = np.arange(ncol)[:, None] - np.arange(128)[None, :]
            KB = ir_rev[:, :, d.clip(0, L - 1)] * ((d >= 0) & (d < L))
            KB = KB.transpose(0, 2, 1, 3).reshape(M, ncol, 256).astype(
                np.float32)
            kb = torch.as_tensor(KB, device=dev)
            self.bank["pool3"] = torch.as_tensor(
                pad_pool_for_windows(rows, L - 1, L - 1), device=dev)
            # torch's bf16 cast rounds to nearest even, as JAX's astype
            self.bank["KB"] = (kb.to(torch.bfloat16)
                               if self.mix_dtype == "bfloat16" else kb)

    # ---------------- batched draws, mixes and labels ----------------

    def scene_batched(self, gen: torch.Generator, batch_size: int,
                      n_src_fixed: int = 0):
        """All per-sample draws, one call per variable -> (active (B, MS)
        bool, sectors, meas, seg_idx, qoff, crop (B, MS) int64). Distinct
        sectors come from an argsort of iid uniforms (a uniformly random
        permutation). qoff counts segment offsets in units of off_step
        samples (128, or 1 when fs % 128 != 0)."""
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
            with precision_highest():
                out = torch.matmul(fw, kb[meas])
        out = out.reshape(B, MS, nf, 2, 128)
        out = out * active.to(out.dtype)[:, :, None, None, None]
        y = out.sum(dim=1).transpose(1, 2).reshape(B, 2, fs)
        peak = torch.clamp(y.abs().amax(dim=(1, 2), keepdim=True), min=1e-8)
        return y / peak

    def mix_general(self, active, meas, seg_idx, qoff, crop) -> torch.Tensor:
        """Segment slices -> full HRIR convolution -> crop -> masked source
        sum -> joint peak normalisation: (B, 2, fs), as JAX's per-sample
        path computes it for every sample at once."""
        B, MS = active.shape
        fs = self.fs
        segs = slice_segments(self.bank["segments"], seg_idx,
                              qoff * self.off_step, fs).reshape(B * MS, fs)
        X = torch.fft.rfft(segs, n=self.fft_len)
        full = torch.fft.irfft(X[:, None] * self.bank["H"][meas.reshape(-1)],
                               n=self.fft_len)
        t = crop.reshape(-1, 1, 1) + torch.arange(fs, device=crop.device)
        out = torch.gather(full, 2, t.expand(-1, 2, -1))
        return normalise_peak(out.reshape(B, MS, 2, fs), active, 1.0)

    def labels_batched(self, active, sectors, meas) -> torch.Tensor:
        """Scatter-free label build -> (B, S * (2 + C))."""
        return sector_labels(active, sectors, self.bank["meas_norm"][meas],
                             self.bank["meas_dcls"][meas].long() + 1,
                             self.n_sectors)

    def assemble(self, gen: torch.Generator, batch_size: int,
                 n_src_fixed: int = 0, with_meta: bool = False, rows=None):
        """One batch (wavL, wavR, x3, y): scene -> mix -> optional noise ->
        CC feature -> labels, of `rows` (start, stop) of the batch or all
        of it; with_meta appends the scene's meta dict
        (``sample_batch_meta``)."""
        sl = row_slice(rows)
        active, sectors, meas, seg_idx, qoff, crop = (
            t[sl] for t in self.scene_batched(gen, batch_size, n_src_fixed))
        mix = self.mix_fast if self.fast else self.mix_general
        y_lr = mix(active, meas, seg_idx, qoff, crop)
        out = finish_batch(gen, y_lr, self.noise_snr_db, self.fs,
                           self.num_lags,
                           self.labels_batched(active, sectors, meas),
                           batch_size, rows)
        if not with_meta:
            return out
        return (*out, host_meta(meas=meas, sector_id=sectors,
                                active=active))

    def sample_batch(self, gen: torch.Generator, batch_size: int,
                     n_src: int | None = None, rows=None):
        """(wavL, wavR, x3, y) with shapes (B, fs) x2, (B, num_lags),
        (B, 56). n_src=None -> Uniform{1..max_sources} per sample; n_src=k
        -> that many sources in every sample. rows=(start, stop): those
        rows of the batch only, from the whole batch's draws."""
        with torch.no_grad():
            return self.assemble(gen, batch_size,
                                 0 if n_src is None else int(n_src),
                                 rows=rows)

    def sample_batch_meta(self, gen: torch.Generator, batch_size: int,
                          n_src: int | None = None):
        """sample_batch's (wavL, wavR, x3, y), from the same draws, plus
        the scene of each sample for the offline writer: {"meas" (the
        HRIR measurement per slot), "sector_id", "active"}, each (B, MS)
        float32 numpy on the host, as JAX's meta."""
        with torch.no_grad():
            return self.assemble(gen, batch_size,
                                 0 if n_src is None else int(n_src),
                                 with_meta=True)

    def batch_fn(self, batch_size: int, n_src: int | None = None,
                 rows=None):
        """gen -> batch closure for the fused train chunk: the same draws
        as sample_batch for the same generator state."""
        return functools.partial(self.sample_batch, batch_size=batch_size,
                                 n_src=n_src, rows=rows)


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
                      num_lags: int = 100, noise_snr_db=None,
                      mix_dtype: str = "float32", device=None):
    """Scene -> synthesizer on `device`, as
    ``tools/generate_binaural_data.py::build_synthesizer`` builds it: the
    anechoic scene over a SOFA HRIR bank, or auditorium ('room') and
    spirit over a SOFA BRIR bank with the scene's loudspeaker geometry and
    the head yaw read from the file; the scene's built-in test bank
    without a SOFA file. num_lags is the CC feature's width (the model's
    n_bands); noise_snr_db (lo, hi) mixes diffuse noise at an SNR drawn
    from U[lo, hi] dB; mix_dtype is the anechoic fast path's HRIR-mix
    operand dtype (the reverberant scenes mix by rFFT, where it does not
    apply)."""
    from .synth_reverb import (ReverbSynthesizer, extract_head_yaw,
                               load_sofa_brir, make_test_brir_bank,
                               scene_speaker_xy)

    if scene == "anechoic":
        if sofa:
            ir, az, dist = load_sofa_hrir(sofa, fs)
        else:
            ir, az, dist = make_test_hrir_bank()
        return AnechoicSynthesizer(ir, az, dist, segments, fs=fs,
                                   num_lags=num_lags,
                                   noise_snr_db=noise_snr_db,
                                   mix_dtype=mix_dtype, device=device)
    if sofa:
        ir, view, pos = load_sofa_brir(sofa, fs)
        yaw, tag = extract_head_yaw(view, pos, ir.shape[0])
        print(f"[SOFA] head yaw axis source: {tag}")
        sxy = scene_speaker_xy(scene, ir.shape[2])
    else:
        sxy = scene_speaker_xy(scene, 3 if scene == "spirit" else 6)
        ir, yaw, sxy = make_test_brir_bank(speaker_xy=sxy)
    return ReverbSynthesizer(ir, yaw, sxy, segments, fs=fs,
                             num_lags=num_lags, noise_snr_db=noise_snr_db,
                             device=device)
