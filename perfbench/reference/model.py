"""Plain reference of the two configured models: the dual adaptive-Q
BiEAR model and AuralNet, forward and loss, in float32 PyTorch.

Written from the model's equations (the BiEAR paper, arXiv 2606.06795,
and the configurations under ``perfbench/configs``), with no import of
the program under test: every GRU is written out gate by gate, every
layer is a product and an elementwise op, and autograd differentiates
the whole forward. Parameters are a dict keyed by the reference
checkpoints' names (``bifb.fb_L.q_rnn.weight_ih_l0``, ``body.0.weight``,
...), which ``param_specs`` lists with their shapes and initial bounds.

Precision: products run in float32 with TF32 off (``no_tf32``), except
where the configuration states bfloat16 operands (``fb_w_dtype``): the
filterbank's products, forward and backward, take bfloat16 operands and
sum in float32 (``GaussBF16``).

Random draws: in training mode the dropout keep-masks come from the
generator in the configuration's order (the controllers' masks of all
frames in one draw, then the body's three, then each sector head's), as
``torch.rand(shape) < 1 - rate``.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

N_SECTORS = 8
N_DIST = 5
ENC_HIDDEN = 200


@contextlib.contextmanager
def no_tf32():
    """TF32 off for the block: true float32 products."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


# ---------------- constants ----------------

def erb_fc_q0(n: int, fmin: float, fmax: float, erb_factor: float = 1.019):
    """ERB-rate spaced centre frequencies and Q0 = fc / (f * ERB(fc))."""
    e_lo = 21.4 * np.log10(4.37 * fmin / 1000.0 + 1.0)
    e_hi = 21.4 * np.log10(4.37 * fmax / 1000.0 + 1.0)
    fc = (10.0 ** (np.linspace(e_lo, e_hi, n) / 21.4) - 1.0) * 1000.0 / 4.37
    q0 = fc / (erb_factor * 24.7 * (4.37 * fc / 1000.0 + 1.0))
    return fc.astype(np.float32), q0.astype(np.float32)


def delta_q(fc, base: float, low: float, high: float):
    """Per-band deltaQ: low -> high along the normalised ERB rate, x base."""
    fc = np.asarray(fc, np.float32)
    e = 21.4 * np.log10(4.37 * fc / 1000.0 + 1.0)
    e = (e - e.min()) / (e.max() - e.min() + 1e-12)
    return np.clip(base * (low + (high - low) * e), 1e-3, None).astype(
        np.float32)


def constants(cfg: dict, device) -> dict:
    """Frame geometry, filterbank and DFT constants of `cfg`, on `device`."""
    fs, T, n_fft, N = cfg["fs"], cfg["timesteps"], cfg["n_fft"], cfg["n_bands"]
    fmax = cfg.get("fmax") or fs / 2.0 * 0.9
    fc, q0 = erb_fc_q0(N, cfg["fmin"], fmax)
    dq = delta_q(fc, cfg["deltaQ_base"], cfg["deltaQ_low_factor"],
                 cfg["deltaQ_high_factor"])
    win = int(round(fs / T))
    hop = max(1, int(round(win * cfg.get("hop_ratio", 1.0))))
    F_ = n_fft // 2 + 1
    f_fft = np.linspace(0.0, fs / 2.0, F_).astype(np.float32)
    qc = np.clip(q0, cfg["q_min"], cfg["q_max"])
    bw = (fc / (qc + 1e-8))[:, None] + 1e-8
    w_fixed = np.exp(-0.5 * ((f_fft[None, :] - fc[:, None]) / bw) ** 2)
    w_fixed = np.nan_to_num(w_fixed / (w_fixed.sum(-1, keepdims=True) + 1e-8))
    n = np.arange(win)
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win))
    ang = -2.0 * np.pi * n[:, None] * np.arange(F_)[None, :] / n_fft
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return {"fc": t(fc), "Q0": t(q0), "dq": t(dq), "f_fft": t(f_fft),
            "W_fixed": t(w_fixed), "win": win, "hop": hop,
            "hann": t(hann.astype(np.float32)),
            "dft_re": t(hann[:, None] * np.cos(ang)),
            "dft_im": t(hann[:, None] * np.sin(ang))}


def dft_matmul(cfg: dict) -> bool:
    mode = cfg.get("dft_mode", "auto")
    return cfg["fb_w_dtype"] == "bfloat16" if mode == "auto" else mode == "matmul"


# ---------------- parameters ----------------

def _linear(name, n_in, n_out):
    b = 1.0 / math.sqrt(n_in)
    return [(f"{name}.weight", (n_out, n_in), b),
            (f"{name}.bias", (n_out,), b)]


def _ln(name, n):
    return [(f"{name}.weight", (n,), "one"), (f"{name}.bias", (n,), "zero")]


def _gru(name, n_in, h):
    b = 1.0 / math.sqrt(h)
    return [(f"{name}.weight_ih_l0", (3 * h, n_in), b),
            (f"{name}.weight_hh_l0", (3 * h, h), b),
            (f"{name}.bias_ih_l0", (3 * h,), b),
            (f"{name}.bias_hh_l0", (3 * h,), b)]


def _controller(name, n_in, H, N):
    return (_gru(f"{name}.q_rnn", n_in, H) + _linear(f"{name}.q_out.0", H, H)
            + _ln(f"{name}.q_out.1", H) + _linear(f"{name}.q_out.4", H, H)
            + _ln(f"{name}.q_out.5", H) + _linear(f"{name}.q_out.8", H, N))


def _body_heads(feat_dim):
    out = (_linear("body.0", feat_dim, 512) + _linear("body.3", 512, 400)
           + _linear("body.6", 400, 200))
    for k in range(N_SECTORS):
        out += _linear(f"subheads.{k}.shared.0", 200, 100)
        for br, n_out in (("sound", 1), ("aoa", 1), ("dist", N_DIST)):
            out += (_linear(f"subheads.{k}.{br}.0", 100, 50)
                    + _linear(f"subheads.{k}.{br}.2", 50, 10)
                    + _linear(f"subheads.{k}.{br}.4", 10, n_out))
    return out


def param_specs(cfg: dict) -> list:
    """[(name, shape, bound)] of the configured model: bound a float for
    U(-bound, bound), or "one" / "zero" for LayerNorm's constants."""
    N = cfg["n_bands"]
    if cfg["family"] == "auralnet":
        d = cfg["d_model"]
        out = []
        for blk in ("attn_L", "attn_R", "attn_diff"):
            out += _linear(f"{blk}.proj", N, d)
            for i in range(cfg["attn_layers"]):
                p = f"{blk}.encoder.layers.{i}"
                out += [(f"{p}.self_attn.in_proj_weight", (3 * d, d),
                         math.sqrt(6.0 / (4 * d))),
                        (f"{p}.self_attn.in_proj_bias", (3 * d,), "zero")]
                out += (_linear(f"{p}.self_attn.out_proj", d, d)
                        + _linear(f"{p}.linear1", d, 4 * d)
                        + _linear(f"{p}.linear2", 4 * d, d)
                        + _ln(f"{p}.norm1", d) + _ln(f"{p}.norm2", d))
        feat = 3 * d
        if cfg["use_cc"]:
            out += _linear("cc_proj", N, d)
            feat += d
        return out + _body_heads(feat)
    H, L = cfg["ctrl_hidden"], cfg["latent_dim"]
    out = (_controller("bifb.fb_L", 2 * N, H, N)
           + _controller("bifb.fb_R", 2 * N, H, N))
    for enc in ("encoder_ild", "encoder_ipd"):
        out += (_ln(f"{enc}.in_norm", N) + _gru(f"{enc}.gru1", N, ENC_HIDDEN)
                + _gru(f"{enc}.gru2", ENC_HIDDEN, L))
    feat = 2 * L
    if cfg["use_cc"]:
        out += _linear("cc_proj", N, L)
        feat += L
    return out + _body_heads(feat)


def make_params(specs: list, gen: torch.Generator) -> dict:
    """Parameters from `specs`, drawn in one call from `gen` (on its
    device): U(-b, b) per leaf, LayerNorm weights 1 and biases 0."""
    sizes = [math.prod(s) for _, s, _ in specs]
    flat = torch.rand(sum(sizes), generator=gen, device=gen.device)
    out, o = {}, 0
    for (name, shape, b), n in zip(specs, sizes):
        u = flat[o:o + n].reshape(shape)
        o += n
        if b == "one":
            out[name] = torch.ones_like(u)
        elif b == "zero":
            out[name] = torch.zeros_like(u)
        else:
            out[name] = (u * (2.0 * b) - b).contiguous()
    return out


# ---------------- layers ----------------

def linear(P, name, x):
    return x @ P[f"{name}.weight"].T + P[f"{name}.bias"]


def layer_norm(P, name, x):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * P[f"{name}.weight"] \
        + P[f"{name}.bias"]


def gru_cell(P, name, x, h):
    """h' = (1 - z) n + z h, gates r, z, n stacked in that order."""
    gi = x @ P[f"{name}.weight_ih_l0"].T + P[f"{name}.bias_ih_l0"]
    gh = h @ P[f"{name}.weight_hh_l0"].T + P[f"{name}.bias_hh_l0"]
    ir, iz, in_ = gi.chunk(3, -1)
    hr, hz, hn = gh.chunk(3, -1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    return (1.0 - z) * n + z * h


def finite(x):
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


class Drops:
    """Dropout keep-masks drawn from `gen` in call order; identity when
    `gen` is None (eval)."""

    def __init__(self, gen):
        self.gen = gen

    def masks(self, rate, shape):
        if self.gen is None or rate <= 0.0:
            return None
        return torch.rand(shape, generator=self.gen,
                          device=self.gen.device) < 1.0 - rate

    def __call__(self, x, rate):
        m = self.masks(rate, x.shape)
        return x if m is None else apply_mask(m, x, rate)


def apply_mask(mask, x, rate):
    return torch.where(mask, x / (1.0 - rate), 0.0)


def bf16_round(x):
    """Round to bfloat16 (nearest even) and back to float32."""
    return x.to(torch.bfloat16).float()


class GaussBF16(torch.autograd.Function):
    """The filterbank's numerators under the bfloat16 policy, (R, N, 4):
    sum_f G[r, n, f] x[r, c, f] over x = [|X|, Re X, Im X, 1], with G and
    x rounded to bfloat16 and float32 sums; G = exp(-0.5 (f - fc)^2 /
    bw^2), bw = fc / (Q + 1e-8) + 1e-8. Its derivative in Q is the
    derivative of G, dG/dQ = -fc / (Q + 1e-8)^2 / bw * G z^2 (z^2 = (f -
    fc)^2 / bw^2), contracted with x under the same policy: G z^2 and x
    rounded to bfloat16, float32 sums."""

    @staticmethod
    def forward(ctx, Q, fc, f, x):
        bw, G, z2 = _gauss(Q, fc, f)
        xb = bf16_round(x)
        ctx.save_for_backward(Q, fc, f, xb)
        return torch.einsum("rnf,rcf->rnc", bf16_round(G), xb)

    @staticmethod
    def backward(ctx, g):
        Q, fc, f, xb = ctx.saved_tensors
        bw, G, z2 = _gauss(Q, fc, f)
        T = torch.einsum("rnf,rcf->rnc", bf16_round(G * z2), xb)
        dQ = -fc / (Q + 1e-8) ** 2 / bw[..., 0] * (g * T).sum(-1)
        return dQ, None, None, None


def _gauss(Q, fc, f):
    """(bw (R, N, 1), G, z^2), G built as exp(D / bw^2), D = -0.5 (f -
    fc)^2."""
    bw = (fc / (Q + 1e-8))[..., None] + 1e-8
    D = f[None, :] - fc[:, None]
    t = (-0.5 * D * D) * (1.0 / (bw * bw))
    return bw, torch.exp(t), -2.0 * t


# ---------------- frontend ----------------

def frames_1s(cfg, c, wav):
    """(B, n) -> (B, T, win): pad or crop to fs, cut T frames of win."""
    fs, T, win, hop = cfg["fs"], cfg["timesteps"], c["win"], c["hop"]
    n = wav.shape[1]
    wav = F.pad(wav, (0, fs - n)) if n < fs else wav[:, :fs]
    take = min((fs - win) // hop + 1, T)
    fr = torch.stack([wav[:, t * hop:t * hop + win] for t in range(take)], 1)
    return F.pad(fr, (0, 0, 0, T - take)) if take < T else fr


def spectra(cfg, c, frames):
    """frames (..., win) -> (|X|, Re X, Im X) of the Hann-windowed frame:
    a DFT product, or an rFFT of length n_fft."""
    if dft_matmul(cfg):
        re, im = frames @ c["dft_re"], frames @ c["dft_im"]
        return torch.sqrt(re * re + im * im), re, im
    X = torch.fft.rfft(frames * c["hann"], n=cfg["n_fft"])
    return X.abs(), X.real, X.imag


def filterbank(cfg, c, Q, X):
    """Adaptive Gaussian filterbank of one frame: Q (R, N), X = (|X|, Re,
    Im) each (R, F) -> (Y, Zre, Zim), each (R, N), row-normalised after
    the contraction (the ones row gives sum_f G). Under the bfloat16
    policy ``GaussBF16``, else float32 autograd."""
    fc, f = c["fc"], c["f_fft"]
    x = torch.stack([*(a.detach() for a in X), torch.ones_like(X[0])], 1)
    if cfg["fb_w_dtype"] == "bfloat16":
        num = GaussBF16.apply(Q, fc, f, x)
    else:
        z = (f[None, :] - fc[:, None]) / ((fc / (Q + 1e-8))[..., None]
                                          + 1e-8)
        num = torch.einsum("rnf,rcf->rnc", torch.exp(-0.5 * z * z), x)
    den = num[..., 3] + 1e-8
    return finite(num[..., 0] / den), num[..., 1] / den, num[..., 2] / den


def band_phase(zre, zim):
    mag = torch.clamp(torch.sqrt(zre * zre + zim * zim), min=1e-3)
    return torch.atan2(zim / mag, zre / mag)


def controller(cfg, P, name, h, feat, drops):
    """GRU step, then [Linear, LN, SiLU, dropout] x2 and Linear -> tanh."""
    rate = cfg["ctrl_dropout"]
    h = gru_cell(P, f"{name}.q_rnn", feat, h)
    z = F.silu(layer_norm(P, f"{name}.q_out.1", linear(P, f"{name}.q_out.0", h)))
    if drops is not None:
        z = apply_mask(drops[0], z, rate)
    z = F.silu(layer_norm(P, f"{name}.q_out.5", linear(P, f"{name}.q_out.4", z)))
    if drops is not None:
        z = apply_mask(drops[1], z, rate)
    return torch.tanh(linear(P, f"{name}.q_out.8", z)), h


def next_q(cfg, c, delta):
    if cfg["deltaQ_mode"].lower() == "relative":
        Q = c["Q0"] * (1.0 + c["dq"] * delta)
    else:
        Q = c["Q0"] + c["dq"] * delta
    return torch.clamp(Q, cfg["q_min"], cfg["q_max"])


def dual_frame(cfg, c, P, carry, XL, XR, drops=None):
    """One frame of the dual frontend: per ear, filter with the carried Q,
    then that ear's controller on [log1p Y, 0.2 log1p Y (no gradient)]
    sets the next Q (a nonfinite Q anywhere in an ear's batch resets that
    ear to Q0 and a zero state). Returns (carry', (Y, Q, phase) per ear)."""
    (QL, hL), (QR, hR) = carry
    out, nxt = [], []
    for ear, Q, h, X in (("L", QL, hL, XL), ("R", QR, hR, XR)):
        Y, zre, zim = filterbank(cfg, c, Q, X)
        out.append((Y, Q, band_phase(zre, zim)))
        yc = torch.log1p(torch.clamp(Y, min=0.0))
        feat = torch.cat([yc, 0.2 * yc.detach()], -1)
        d = None if drops is None else drops[0 if ear == "L" else 1]
        delta, h2 = controller(cfg, P, f"bifb.fb_{ear}", h, feat, d)
        Qn = next_q(cfg, c, delta)
        ok = torch.isfinite(Qn).all()
        nxt.append((torch.where(ok, Qn, c["Q0"].expand_as(Qn)),
                    torch.where(ok, h2, torch.zeros_like(h2))))
    return tuple(nxt), tuple(out)


def init_carry(cfg, c, B, device):
    z = lambda: torch.zeros((B, cfg["ctrl_hidden"]), device=device)
    q = lambda: c["Q0"].expand(B, cfg["n_bands"])
    return ((q(), z()), (q(), z()))


def encoder(P, name, x):
    """LayerNorm -> GRU(N -> 200) -> GRU(200 -> latent) over the frames,
    then the time mean."""
    x = layer_norm(P, f"{name}.in_norm", x)
    B, T, _ = x.shape
    h1 = x.new_zeros(B, P[f"{name}.gru1.weight_hh_l0"].shape[1])
    h2 = x.new_zeros(B, P[f"{name}.gru2.weight_hh_l0"].shape[1])
    acc = 0.0
    for t in range(T):
        h1 = gru_cell(P, f"{name}.gru1", x[:, t], h1)
        h2 = gru_cell(P, f"{name}.gru2", h1, h2)
        acc = acc + h2
    return finite(acc / T)


def ild(x1, x2):
    return torch.clamp(finite(x1 - x2), -10.0, 10.0)


def ipd(p1, p2):
    d = p1 - p2
    return finite(torch.atan2(torch.sin(d), torch.cos(d)))


def log_energy(Y):
    return torch.clamp(torch.log(Y + 1e-8), -12.0, 12.0)


def heads(cfg, P, feats, x3, drop: Drops):
    """CC projection, body (Linear-ReLU-dropout x3) and the sector heads
    -> (sound logits (B, S), aoa (B, S), dist logits (B, S, C))."""
    rate = cfg["backend_dropout"]
    if cfg["use_cc"]:
        feats = feats + [linear(P, "cc_proj", x3)]
    x = torch.cat(feats, -1)
    for i in (0, 3, 6):
        x = drop(torch.relu(linear(P, f"body.{i}", x)), rate)
    sound, aoa, dist = [], [], []
    for k in range(N_SECTORS):
        h = drop(torch.relu(linear(P, f"subheads.{k}.shared.0", x)), rate)

        def branch(br):
            y = torch.relu(linear(P, f"subheads.{k}.{br}.0", h))
            y = torch.relu(linear(P, f"subheads.{k}.{br}.2", y))
            return linear(P, f"subheads.{k}.{br}.4", y)
        sound.append(branch("sound")[..., 0])
        aoa.append(torch.sigmoid(branch("aoa"))[..., 0])
        dist.append(branch("dist"))
    return (torch.stack(sound, -1), torch.stack(aoa, -1),
            torch.stack(dist, 1))


def active_forward(cfg, c, P, wavL, wavR, x3, gen=None):
    """The dual adaptive-Q model: (sound, aoa, dist, Q (B, T, N) mean of
    the ears). `gen` (training) draws the dropout masks."""
    B, T, H = wavL.shape[0], cfg["timesteps"], cfg["ctrl_hidden"]
    XL = spectra(cfg, c, frames_1s(cfg, c, wavL))
    XR = spectra(cfg, c, frames_1s(cfg, c, wavR))
    drop = Drops(gen)
    masks = drop.masks(cfg["ctrl_dropout"], (T, 2, 2, B, H))
    carry = init_carry(cfg, c, B, wavL.device)
    YL, YR, QL, QR, pL, pR = ([] for _ in range(6))
    for t in range(T):
        carry, ((yl, ql, phl), (yr, qr, phr)) = dual_frame(
            cfg, c, P, carry, tuple(x[:, t] for x in XL),
            tuple(x[:, t] for x in XR), None if masks is None else masks[t])
        for lst, v in zip((YL, YR, QL, QR, pL, pR),
                          (yl, yr, ql, qr, phl, phr)):
            lst.append(v)
    st = lambda a: torch.stack(a, 1)
    x1, x2 = log_energy(st(YL)), log_energy(st(YR))
    z = [encoder(P, "encoder_ild", ild(x1, x2)),
         encoder(P, "encoder_ipd", ipd(st(pL), st(pR)))]
    s, a, d = heads(cfg, P, z, x3, drop)
    return s, a, d, 0.5 * (st(QL) + st(QR))


def sinusoidal_pe(T: int, d: int, device):
    pos = np.arange(T, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32)
                 * (-math.log(10000.0) / d))
    pe = np.zeros((T, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.as_tensor(pe, device=device)


def attn_block(cfg, P, name, x, drop: Drops):
    """Projection + positional encoding, then pre-norm encoder layers
    (multi-head self-attention, exact-GELU feed-forward d -> 4d -> d),
    dropout on the attention weights, both residual branches and after
    the GELU."""
    rate, nh = cfg["attn_dropout"], cfg["attn_heads"]
    h = linear(P, f"{name}.proj", x)
    h = h + sinusoidal_pe(x.shape[1], h.shape[-1], h.device)[None]
    B, T, d = h.shape
    hd = d // nh
    for i in range(cfg["attn_layers"]):
        p = f"{name}.encoder.layers.{i}"
        u = layer_norm(P, f"{p}.norm1", h)
        qkv = u @ P[f"{p}.self_attn.in_proj_weight"].T \
            + P[f"{p}.self_attn.in_proj_bias"]
        q, k, v = (t.reshape(B, T, nh, hd).transpose(1, 2)
                   for t in qkv.chunk(3, -1))
        w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), -1)
        w = drop(w, rate)
        a = linear(P, f"{p}.self_attn.out_proj",
                   (w @ v).transpose(1, 2).reshape(B, T, d))
        h = h + drop(a, rate)
        f = F.gelu(linear(P, f"{p}.linear1", layer_norm(P, f"{p}.norm2", h)))
        h = h + drop(linear(P, f"{p}.linear2", drop(f, rate)), rate)
    return h


def auralnet_forward(cfg, c, P, wavL, wavR, x3, gen=None):
    """AuralNet: fixed-Q magnitude filterbank (float32) per ear, log, the
    three attention blocks (left, right, left - right), their frame
    means, then the CC projection, body and heads."""
    drop = Drops(gen)
    xs = []
    for w in (wavL, wavR):
        mag = spectra(cfg, c, frames_1s(cfg, c, torch.clamp(w, -1.0, 1.0)))[0]
        xs.append(log_energy(finite(mag @ c["W_fixed"].T)))
    z = [attn_block(cfg, P, "attn_L", xs[0], drop).mean(1),
         attn_block(cfg, P, "attn_R", xs[1], drop).mean(1),
         attn_block(cfg, P, "attn_diff", xs[0] - xs[1], drop).mean(1)]
    s, a, d = heads(cfg, P, z, x3, drop)
    return s, a, d, None


# ---------------- loss ----------------

def sanitize(wavL, wavR, x3):
    """Waveforms: /32768 when the batch looks like int16, clamp +-1; x3:
    nan to 0, peak-normalised with floor 1, clamp +-5."""
    mx = torch.maximum(wavL.abs().max(), wavR.abs().max())
    s = torch.where(mx > 2.0, 1.0 / 32768.0, 1.0)
    wavL = torch.clamp(wavL * s, -1.0, 1.0)
    wavR = torch.clamp(wavR * s, -1.0, 1.0)
    x3 = finite(x3)
    x3 = torch.clamp(x3 / torch.clamp(x3.abs().amax(1, keepdim=True),
                                      min=1.0), -5.0, 5.0)
    return wavL, wavR, x3


def loss(cfg, hp, c, P, batch, gen=None):
    """The weighted task loss (BCE with pos_weight on presence, smooth L1
    on the in-sector angle, cross-entropy on distance), plus the Q
    regularisers for the adaptive model."""
    wavL, wavR, x3, y = batch
    wavL, wavR, x3 = sanitize(wavL, wavR, x3)
    fwd = auralnet_forward if cfg["family"] == "auralnet" else active_forward
    s, a, d, Q = fwd(cfg, c, P, wavL, wavR, x3, gen)
    y = y.reshape(y.shape[0], N_SECTORS, 2 + N_DIST)
    ys, ya, yd = y[..., 0], y[..., 1], y[..., 2:]
    sp = lambda x: torch.logaddexp(x, torch.zeros_like(x))
    l_s = (hp["pos_weight"] * ys * sp(-s) + (1.0 - ys) * sp(s)).mean()
    e = torch.abs(a - ya)
    l_a = torch.where(e < 0.02, 0.5 * e * e / 0.02, e - 0.01).mean()
    l_d = -torch.gather(torch.log_softmax(d, -1), -1,
                        torch.argmax(yd, -1)[..., None]).mean()
    total = (hp["loss_w_sound"] * l_s + hp["loss_w_aoa"] * l_a
             + hp["loss_w_dist"] * l_d)
    if Q is not None:
        lq = torch.log(Q + 1e-8)
        total = total + hp["reg_q_w"] * ((lq - torch.log(c["Q0"] + 1e-8))
                                         ** 2).mean() \
            + hp["reg_smooth_w"] * ((lq[..., 1:] - lq[..., :-1]) ** 2).mean()
    return total
