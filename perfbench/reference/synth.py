"""Plain reference of the scene synthesis: the scene draws, the
HRIR / BRIR mix, the cross-correlation feature x3 and the labels.

Written from the scene's definition, with no import of the program:

  * anechoic: 1-3 sources (uniform), each in a distinct 45-degree sector
    (an argsort of uniforms), its measurement uniform among the sector's,
    a 1 s speech slice convolved with the measurement's HRIR pair and
    cropped at a uniform offset in [0, L - 1] of the full convolution;
    active sources summed and scaled to a joint peak of 1;
  * spirit (reverberant): a head yaw, 1-3 sources over the occupied
    sectors (uniform priorities), one loudspeaker per chosen sector
    (uniform, preferring unused ones), the 1 s slice convolved with the
    (yaw, speaker) BRIR pair and truncated to 1 s; peak 0.9.

The draws are the configured scene's, taken from the generator in its
order and shapes, so the same seed gives the same scenes. Mixing is a
float64 FFT convolution; under the bfloat16 mix policy the speech slice
and the HRIR taps are first rounded to bfloat16 (the policy's operands).
x3: the mean-removed ears correlated at lags -3..3 ms, peak-normalised
and linearly resampled to `num_lags` points (numpy's interp), in float64.
"""

from __future__ import annotations

import numpy as np
import torch

N_SECTORS = 8
N_DIST = 5
DIST_PROTOS = np.array([0.5, 1.0, 2.0, 3.0])


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def fft_conv(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Full linear convolution along the last axis, float64."""
    n = x.shape[-1] + h.shape[-1] - 1
    m = next_pow2(n)
    X = torch.fft.rfft(x.double(), n=m)
    H = torch.fft.rfft(h.double(), n=m)
    return torch.fft.irfft(X * H, n=m)[..., :n]


def lag_interp(n: int, fs: int, num_lags: int, max_ms: float = 3.0):
    """(kept integer lags, left index, weight) resampling the kept lags'
    values onto linspace(-max, max, num_lags) seconds as np.interp does."""
    lags = np.arange(-n + 1, n) / float(fs)
    mls = max_ms * 1e-3
    kept = np.nonzero((lags >= -mls) & (lags <= mls))[0] - (n - 1)
    x = kept / float(fs)
    tgt = np.linspace(-mls, mls, num_lags)
    j = np.clip(np.searchsorted(x, tgt, side="left"), 1, len(x) - 1)
    w = np.clip((tgt - x[j - 1]) / (x[j] - x[j - 1]), 0.0, 1.0)
    return kept, j - 1, w


def centered_lags(left: torch.Tensor, right: torch.Tensor,
                  K: int) -> torch.Tensor:
    """corr[l] = sum_m (L[m + l] - mean L)(R[m] - mean R) for l in -K..K,
    float64, (R, 2K + 1)."""
    left, right = left.double(), right.double()
    n = left.shape[1]
    lf = left - left.mean(1, keepdim=True)
    rf = right - right.mean(1, keepdim=True)
    m = next_pow2(n + K)
    c = torch.fft.irfft(torch.fft.rfft(lf, n=m)
                        * torch.conj(torch.fft.rfft(rf, n=m)), n=m)
    idx = torch.arange(-K, K + 1, device=left.device) % m
    return c[:, idx]


def cc_feature(corr: torch.Tensor, fs: int, num_lags: int) -> torch.Tensor:
    """Kept lags (R, 2K + 1) -> x3 (R, num_lags) float32 (the 1 s lag
    plan)."""
    kept, j0, w = lag_interp(fs, fs, num_lags)
    if corr.shape[1] != len(kept):
        raise ValueError("lag window does not match the 1 s plan")
    c = corr / (corr.abs().amax(1, keepdim=True) + 1e-8)
    j0 = torch.as_tensor(j0, device=corr.device)
    w = torch.as_tensor(w, device=corr.device)
    return (c[:, j0] + w * (c[:, j0 + 1] - c[:, j0])).float()


def x3_of(wavL: torch.Tensor, wavR: torch.Tensor, fs: int,
          num_lags: int) -> torch.Tensor:
    K = (len(lag_interp(fs, fs, num_lags)[0]) - 1) // 2
    return cc_feature(centered_lags(wavL, wavR, K), fs, num_lags)


def labels(active, sectors, norm, dist_onehot) -> torch.Tensor:
    """(B, S * 7): per sector [presence, in-sector angle, 5-way distance
    one-hot], class 0 where no active source is."""
    B, MS = active.shape
    y = torch.zeros(B, N_SECTORS, 2 + N_DIST, device=active.device)
    y[:, :, 2] = 1.0
    rows = torch.arange(B, device=active.device)
    for j in range(MS):
        b, s = rows[active[:, j]], sectors[active[:, j], j]
        y[b, s, 0] = 1.0
        y[b, s, 1] = norm[active[:, j], j].float()
        y[b, s, 2] = 0.0
        y[b, s, 2 + dist_onehot[active[:, j], j]] = 1.0
    return y.reshape(B, -1)


class Anechoic:
    """The anechoic scene over an HRIR bank (M, 2, L), azimuths, distances
    and a speech pool (P, >= fs), on `device`."""

    def __init__(self, ir, az, dist, segments, fs, num_lags, mix_dtype,
                 device, max_sources: int = 3):
        self.fs, self.num_lags, self.MS = fs, num_lags, max_sources
        self.device = device
        az = np.asarray(az, np.float64) % 360.0
        width = 360.0 / N_SECTORS
        sec = np.floor(az / width).astype(np.int64) % N_SECTORS
        groups = [np.nonzero(sec == s)[0] for s in range(N_SECTORS)]
        kmax = max(len(g) for g in groups)
        self.table = torch.as_tensor(np.stack(
            [np.pad(g, (0, kmax - len(g)), mode="edge") for g in groups]),
            device=device)
        self.counts = torch.as_tensor([len(g) for g in groups], device=device)
        self.norm = torch.as_tensor(np.minimum(
            (az - sec * width + 1e-3) / width, 1.0), device=device)
        dcls = np.argmin(np.abs(DIST_PROTOS[None] - np.asarray(dist)[:, None]),
                         axis=1)
        self.dclass = torch.as_tensor(dcls + 1, device=device)
        segs = np.asarray(segments, np.float32)
        step = 128 if fs % 128 == 0 else 1
        if step == 128 and segs.shape[1] % 128:
            segs = np.pad(segs, ((0, 0), (0, 128 - segs.shape[1] % 128)))
        self.step = step
        self.n_q = (np.asarray(segments).shape[1] - fs) // step + 1
        self.segs = torch.as_tensor(segs, device=device)
        ir = torch.as_tensor(np.asarray(ir, np.float32), device=device)
        self.L = ir.shape[-1]
        bf16 = mix_dtype == "bfloat16"
        self.rnd = ((lambda a: a.to(torch.bfloat16).double()) if bf16
                    else (lambda a: a.double()))
        self.ir = self.rnd(ir)

    def draws(self, gen, B):
        dev, MS = self.device, self.MS
        n_src = torch.randint(1, MS + 1, (B,), generator=gen, device=dev)
        active = torch.arange(MS, device=dev)[None] < n_src[:, None]
        sectors = torch.argsort(torch.rand((B, N_SECTORS), generator=gen,
                                           device=dev), dim=1)[:, :MS]
        u = torch.rand((B, MS), generator=gen, device=dev)
        cnt = self.counts[sectors]
        meas = self.table[sectors, torch.minimum((u * cnt).long(), cnt - 1)]
        seg = torch.randint(0, self.segs.shape[0], (B, MS), generator=gen,
                            device=dev)
        q = torch.randint(0, self.n_q, (B, MS), generator=gen, device=dev)
        crop = torch.randint(0, self.L, (B, MS), generator=gen, device=dev)
        return active, sectors, meas, seg, q, crop

    def batch(self, gen, B):
        """(wavL, wavR, x3, y) of one batch; the waves float64."""
        active, sectors, meas, seg, q, crop = self.draws(gen, B)
        fs = self.fs
        t = torch.arange(fs, device=self.device)
        x = self.segs[seg[..., None], (q * self.step)[..., None] + t]
        full = fft_conv(self.rnd(x)[:, :, None], self.ir[meas])  # (B,MS,2,n)
        idx = (crop[..., None, None] + t).expand(-1, -1, 2, -1)
        src = torch.gather(full, 3, idx)
        y = (src * active[..., None, None]).sum(1)
        y = y / torch.clamp(y.abs().amax((1, 2), keepdim=True), min=1e-8)
        x3 = x3_of(y[:, 0], y[:, 1], fs, self.num_lags)
        return (y[:, 0], y[:, 1], x3,
                labels(active, sectors, self.norm[meas], self.dclass[meas]))


class Spirit:
    """The reverberant scene over a BRIR bank (M, 2, E, L), head yaws,
    loudspeaker positions (E, 2) and a speech pool, on `device`."""

    def __init__(self, ir, yaw, speaker_xy, segments, fs, num_lags, device,
                 max_sources: int = 3):
        self.fs, self.num_lags, self.MS, self.device = (fs, num_lags,
                                                        max_sources, device)
        xy = np.asarray(speaker_xy, np.float64)
        d = np.sqrt((xy ** 2).sum(1))
        az = np.degrees(np.arctan2(xy[:, 1], xy[:, 0])) % 360.0
        rel = (az[None] - np.asarray(yaw, np.float64)[:, None] % 360.0) % 360.0
        width = 360.0 / N_SECTORS
        sec = np.clip(np.floor(rel / width).astype(np.int64), 0, N_SECTORS - 1)
        self.sec = torch.as_tensor(sec, device=device)             # (M, E)
        self.norm = torch.as_tensor(np.minimum(
            (rel - sec * width + 1e-3) / width, 1.0), device=device)
        near = np.argmin(np.abs(DIST_PROTOS[None] - d[:, None]), axis=1)
        cls = np.where(d > 3.0, 4, near)
        self.dclass = torch.as_tensor(np.minimum(cls + 1, N_DIST - 1),
                                      device=device)
        segs = np.asarray(segments, np.float32)
        step = 128 if fs % 128 == 0 else 1
        if step == 128 and segs.shape[1] % 128:
            segs = np.pad(segs, ((0, 0), (0, 128 - segs.shape[1] % 128)))
        self.step = step
        self.n_q = (np.asarray(segments).shape[1] - fs) // step + 1
        self.segs = torch.as_tensor(segs, device=device)
        self.ir = torch.as_tensor(np.asarray(ir, np.float64), device=device)
        self.M, _, self.E, _ = self.ir.shape

    def draws(self, gen, B):
        dev, MS, E = self.device, self.MS, self.E
        head = torch.randint(0, self.M, (B,), generator=gen, device=dev)
        n_src = torch.randint(1, MS + 1, (B,), generator=gen, device=dev)
        spk_sec = self.sec[head]                                    # (B, E)
        occ = (spk_sec[..., None] == torch.arange(N_SECTORS, device=dev)
               ).any(1)
        n_eff = torch.minimum(n_src, occ.sum(1))
        prio = (torch.rand((B, N_SECTORS), generator=gen, device=dev)
                + torch.where(occ, 0.0, -1e9))
        sectors = torch.argsort(prio, dim=1, descending=True)[:, :MS]
        active = torch.arange(MS, device=dev)[None] < n_eff[:, None]
        used = torch.zeros((B, E), dtype=torch.bool, device=dev)
        spk = []
        for j in range(MS):
            cand = spk_sec == sectors[:, j:j + 1]
            r = torch.rand((B, E), generator=gen, device=dev)
            s = (r + torch.where(cand, 0.0, -1e9)
                 + torch.where(used, -1e3, 0.0)).argmax(1)
            used = used | (s[:, None] == torch.arange(E, device=dev))
            spk.append(s)
        spk = torch.stack(spk, 1)
        seg = torch.randint(0, self.segs.shape[0], (B, MS), generator=gen,
                            device=dev)
        q = torch.randint(0, self.n_q, (B, MS), generator=gen, device=dev)
        return head, active, sectors, spk, seg, q

    def batch(self, gen, B):
        head, active, sectors, spk, seg, q = self.draws(gen, B)
        fs = self.fs
        t = torch.arange(fs, device=self.device)
        x = self.segs[seg[..., None], (q * self.step)[..., None] + t]
        h = self.ir[head[:, None], :, spk]                      # (B, MS, 2, L)
        src = fft_conv(x.double()[:, :, None], h)[..., :fs]
        y = (src * active[..., None, None]).sum(1)
        y = 0.9 * y / torch.clamp(y.abs().amax((1, 2), keepdim=True),
                                  min=1e-8)
        x3 = x3_of(y[:, 0], y[:, 1], fs, self.num_lags)
        return (y[:, 0], y[:, 1], x3,
                labels(active, sectors, self.norm[head[:, None], spk],
                       self.dclass[spk]))
