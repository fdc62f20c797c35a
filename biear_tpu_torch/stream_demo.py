#!/usr/bin/env python
"""Anytime streaming localisation on a trained protocol checkpoint.

    python -m biear_tpu_torch.stream_demo \\
        [--archive docs/protocol_r3/flagship-s1] [--n-src 2] [--seed 4] \\
        [--pool-size 64] [--json runs_demo/stream_demo.json] \\
        [--png runs_demo/stream_demo.png] [--device cpu]

Counterpart of ``tools/stream_demo.py``. It loads a protocol archive
(settings.json + best.pth), synthesises one speech + noise scene from the
generator family the protocol trained on (the speech corpus at fs + 7 *
128 samples per segment, pool seed + 1; diffuse noise at 5-25 dB SNR),
feeds it to the streaming server (``serve/streaming.py``) one hop at a
time, with the residual tail at the last hop, and reads the 8-sector
presence belief after every hop. Output: the per-hop beliefs as JSON
(the JAX tool's fields) and, where ``matplotlib`` imports, a figure of
the belief converging on the true sectors while the audio still plays.
It runs on the card unless ``--device cpu`` is given. torch's random
streams are not JAX's, so a seed makes another scene than the JAX tool's.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .config import config_from_settings, family
from .data.speech import make_speech_pool
from .data.synth import build_synthesizer
from .device import resolve_device
from .serve.infer import load_model
from .serve.streaming import (stream_init, stream_plan, stream_readout,
                              stream_step)

# Colours: the first three categorical slots of a light palette for the
# <= 3 active sources, muted gray for the other sectors, ink for text.
SLOTS = ["#2a78d6", "#eb6834", "#1baf7a"]
GRAY = "#b8b7ae"
INK, INK2 = "#1a1a19", "#6b6a60"


def demo_scene(cfg, n_src: int, seed: int, pool_size: int = 64,
               device=None):
    """One scene of the protocol's generator family on `device`: (wavL,
    wavR (1, fs) tensors, the true sectors)."""
    pool = make_speech_pool(pool_size, seg_len=cfg.fs + 7 * 128, fs=cfg.fs,
                            seed=seed + 1)
    synth = build_synthesizer("anechoic", None, pool, cfg.fs,
                              num_lags=cfg.n_bands, noise_snr_db=(5.0, 25.0),
                              device=device)
    gen = torch.Generator(device=synth.device).manual_seed(seed)
    wavL, wavR, _, y, _ = synth.sample_batch_meta(gen, 1, n_src=n_src)
    gt = y.cpu().numpy().reshape(8, 7)
    return wavL, wavR, np.nonzero(gt[:, 0] > 0.5)[0].tolist()


def stream_beliefs(model, wavL, wavR) -> np.ndarray:
    """The first stream of (B, fs) waveforms, hop by hop: its sector
    presence probabilities after each of the T hops, (T, 8) numpy; the
    last readout takes the residual tail."""
    plan = stream_plan(model.cfg)
    hop, T = plan["hop"], model.cfg.timesteps
    dev = next(model.parameters()).device
    wavL = torch.as_tensor(wavL, device=dev).float()
    wavR = torch.as_tensor(wavR, device=dev).float()
    state = stream_init(model, wavL.shape[0])
    probs = []
    for t in range(T):
        sl = slice(t * hop, (t + 1) * hop)
        state = stream_step(model, state, wavL[:, sl], wavR[:, sl])
        tail = ((wavL[:, T * hop:], wavR[:, T * hop:]) if t == T - 1
                else (None, None))
        sound = stream_readout(model, state, *tail)[0]
        probs.append(torch.sigmoid(sound)[0].cpu().numpy())
    return np.stack(probs)


def settled_hop(probs, gt_sectors):
    """The first hop from which the thresholded belief equals the true
    sectors and stays so (None if it never does)."""
    correct = [sorted(np.nonzero(p > 0.5)[0].tolist()) == sorted(gt_sectors)
               for p in probs]
    return next((i for i in range(len(probs)) if all(correct[i:])), None)


def plot(probs, gt_sectors, t_axis, settle, hop_ms: float, n_src: int,
         path: str) -> bool:
    """The belief figure; False (and nothing written) without
    matplotlib."""
    try:
        import matplotlib
    except ImportError:
        print("[stream_demo] matplotlib is not installed: no figure")
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7.2, 4.0), dpi=150)
    fig.patch.set_facecolor("white")
    ax.set_facecolor("white")
    for s in range(8):
        if s not in gt_sectors:
            ax.plot(t_axis, probs[:, s], color=GRAY, lw=1.4, zorder=2,
                    label="inactive sectors" if s == min(
                        set(range(8)) - set(gt_sectors)) else None)
    # labels at the line ends, dodged apart where the active lines meet
    ends = sorted(((float(probs[-1, s]), s) for s in gt_sectors))
    label_y = []
    for v, _ in ends:
        if label_y and v - label_y[-1] < 0.07:
            v = label_y[-1] + 0.07
        label_y.append(v)
    for (v, s), ly in zip(ends, label_y):
        i = gt_sectors.index(s)
        ax.plot(t_axis, probs[:, s], color=SLOTS[i % 3], lw=2.0, zorder=3,
                label=f"sector {s} (source present)")
        ax.annotate(f"sector {s}", (t_axis[-1], ly), xytext=(4, 0),
                    textcoords="offset points", color=INK, fontsize=9,
                    va="center", annotation_clip=False)
    ax.axhline(0.5, color=INK2, lw=1.0, ls=(0, (4, 4)), zorder=1)
    ax.annotate("decision threshold", (t_axis[0], 0.5), xytext=(2, 5),
                textcoords="offset points", color=INK2, fontsize=8,
                bbox=dict(fc="white", ec="none", pad=0.4))
    if settle is not None and settle > 0:
        ax.axvline(t_axis[settle], color=INK2, lw=1.0, ls=(0, (2, 3)),
                   zorder=1)
        ax.annotate(f"settled: {t_axis[settle] * 1e3:.0f} ms",
                    (t_axis[settle], 1.02), color=INK2, fontsize=8,
                    ha="center", annotation_clip=False,
                    bbox=dict(fc="white", ec="none", pad=0.4))
    ax.set_xlim(0, float(t_axis[-1]) * 1.12)
    ax.set_ylim(-0.02, 1.05)
    ax.set_xlabel("audio streamed (s)", color=INK)
    ax.set_ylabel("sector presence belief", color=INK)
    ax.set_title(f"Anytime streaming localisation — {n_src} speech "
                 f"sources in noise,\none belief update per {hop_ms:.1f} ms "
                 "hop", color=INK, fontsize=10, loc="left")
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    for spine in ("left", "bottom"):
        ax.spines[spine].set_color(INK2)
    ax.tick_params(colors=INK2, labelsize=8)
    ax.grid(axis="y", color="#eceae2", lw=0.8, zorder=0)
    ax.legend(loc="center right", bbox_to_anchor=(1.0, 0.3), fontsize=8,
              frameon=False, labelcolor=INK)
    fig.tight_layout()
    fig.savefig(path, facecolor="white")
    plt.close(fig)
    return True


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archive", default="docs/protocol_r3/flagship-s1")
    ap.add_argument("--n-src", type=int, default=2)
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--pool-size", type=int, default=64)
    ap.add_argument("--png", default="runs_demo/stream_demo.png")
    ap.add_argument("--json", default="runs_demo/stream_demo.json")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    with open(os.path.join(args.archive, "settings.json")) as f:
        settings = json.load(f)
    cfg = config_from_settings(settings)
    model = load_model(os.path.join(args.archive, "best.pth"), cfg, device,
                       kind=family(settings))
    wavL, wavR, gt_sectors = demo_scene(cfg, args.n_src, args.seed,
                                        args.pool_size, device)
    probs = stream_beliefs(model, wavL, wavR)

    hop, T = stream_plan(cfg)["hop"], cfg.timesteps
    t_axis = np.arange(1, T + 1) * hop / cfg.fs
    settle = settled_hop(probs, gt_sectors)
    out = {"archive": args.archive, "n_src": args.n_src, "seed": args.seed,
           "gt_sectors": gt_sectors,
           "pred_sectors": np.nonzero(probs[-1] > 0.5)[0].tolist(),
           "settled_at_hop": settle,
           "settled_at_s": None if settle is None else round(
               float(t_axis[settle]), 3),
           "hop_s": round(hop / cfg.fs, 4),
           "probs_per_hop": [[round(float(v), 4) for v in p] for p in probs]}
    for path in (args.json, args.png):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in list(out)[:8]}, indent=1))
    drawn = plot(probs, gt_sectors, t_axis, settle, 1e3 * hop / cfg.fs,
                 args.n_src, args.png)
    print(f"wrote {args.json}" + (f" and {args.png}" if drawn else ""))
    return out


if __name__ == "__main__":
    main()
