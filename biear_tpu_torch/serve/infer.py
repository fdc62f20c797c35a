#!/usr/bin/env python
"""Inference: stereo waveforms in, per-sector localisation out.

Counterpart of ``tools/infer.py``. ``predict`` is its composition:
sanitize the waveforms, compute the CC feature (the CUDA lag kernel on the
card), sanitize it, run the model's eval forward (the active model or
AuralNet, by the settings' MODEL_KIND), then a sigmoid on the presence
logits and a softmax on the distance logits. On the card the whole
composition is one captured CUDA graph per batch shape and precision, as
``tools/infer.py``'s is one ``jax.jit``.

Command line (a reference-format ``.pth`` with its ``meta/settings.json``
in the same directory or up to two levels above):

    python -m biear_tpu_torch.serve.infer --checkpoint run/best.pth a.wav b.wav

It runs on the card unless ``--device cpu`` is given, under the settings'
MATMUL_PRECISION (``device.matmul_precision``). Orbax checkpoints of
the JAX runner are not read: convert them with
``biear_tpu_torch.train.state`` where JAX is installed (README.md).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..config import (config_from_settings,  # noqa: F401 (re-exported)
                      family, load_settings_near_checkpoint)
from ..device import matmul_precision, resolve_device
from ..models.auralnet import AuralNet
from ..models.biear import ActiveBiEAR, PassiveBiEAR
from ..models.config import BiEARConfig
from ..ops.xcorr import cross_correlation_feature
from ..graph import captured_forward, host_input, use_capture
from ..train.losses import sanitize_wav, sanitize_x3

DIST_NAMES = ["none", "0.5m", "1m", "2m", "3m"]
MODELS = {"active": ActiveBiEAR, "auralnet": AuralNet,
          "passive": PassiveBiEAR}


def _predict(model: ActiveBiEAR | AuralNet, wavL, wavR):
    cfg = model.cfg
    wavL, wavR = sanitize_wav(wavL, wavR)
    x3 = sanitize_x3(cross_correlation_feature(wavL, wavR, cfg.fs,
                                               num_lags=cfg.n_bands))
    sound, aoa, dist, _ = model(wavL, wavR, x3)
    return torch.sigmoid(sound), aoa, torch.softmax(dist, dim=-1)


@torch.inference_mode()
def predict(model: ActiveBiEAR | AuralNet, wavL, wavR, *,
            capture: bool | None = None):
    """(B, Nsamp) x2 (numpy or tensors) -> (presence probabilities (B, S),
    AoA in [0, 1] (B, S), distance probabilities (B, S, C)), on the
    model's device.

    On a CUDA device the whole composition (the CC kernel included)
    replays the model's captured graph for the inputs' shapes and the
    precision policy (``graph.captured_forward``; JAX's one
    ``jax.jit``), numpy inputs copied from pinned memory; the CPU and
    ``capture=False`` run it eagerly."""
    if use_capture(model, None, capture):
        fwd = captured_forward(model, "predict",
                               lambda l, r: _predict(model, l, r))
        return fwd((host_input(wavL), host_input(wavR)))
    device = next(model.parameters()).device
    return _predict(model, torch.as_tensor(wavL, device=device),
                    torch.as_tensor(wavR, device=device))


# ---------------- checkpoint ----------------

def load_state_dict(path: str) -> dict:
    """A reference-format .pth, unwrapped from {"state_dict"} / {"model"}."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and not hasattr(obj["model"],
                                                                "shape"):
        obj = obj["model"]
    return obj


def load_model(pth: str, cfg: BiEARConfig, device=None,
               kind: str = "active"):
    """The model of `kind` (active, auralnet or passive: ``config.family``
    of the settings) with the .pth weights on `device` (the card by
    default).

    Every parameter of the model must be in the file, or the load raises
    and names the missing keys; entries the model does not have (the
    reference model's constant buffers) are ignored."""
    device = resolve_device(device)
    model = MODELS[kind](cfg)
    sd = load_state_dict(pth)
    own = model.state_dict()
    model.load_state_dict({k: v for k, v in sd.items() if k in own},
                          strict=True)
    return model.to(device)


def read_stereo_wav(path: str, fs: int):
    """(left, right) float32 at fs, exactly fs samples each."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    rate, data = wavfile.read(path)
    if data.ndim == 1:
        raise ValueError(f"{path}: mono wav; the model is binaural")
    if np.issubdtype(data.dtype, np.integer):
        data = data.astype(np.float32) / 32768.0
    else:
        data = data.astype(np.float32)
    if rate != fs:
        data = resample_poly(data, fs, rate, axis=0).astype(np.float32)
    out = np.zeros((fs, 2), np.float32)
    n = min(fs, data.shape[0])
    out[:n] = data[:n, :2]
    return out[:, 0], out[:, 1]


def records(paths, probs, aoa, distp, threshold: float):
    """One JSON-ready record per file, the fields of tools/infer.py."""
    for i, path in enumerate(paths):
        sectors = []
        for sct in range(probs.shape[1]):
            sectors.append({
                "sector": sct,
                "present": round(float(probs[i, sct]), 4),
                "aoa_deg": round(45.0 * sct + 45.0 * float(aoa[i, sct]), 2),
                "distance": DIST_NAMES[int(distp[i, sct].argmax())],
                "dist_probs": [round(float(x), 4) for x in distp[i, sct]],
            })
        detected = [s for s in sectors if s["present"] >= threshold]
        yield {"file": path, "n_detected": len(detected),
               "detected": [{k: s[k] for k in
                             ("sector", "present", "aoa_deg", "distance")}
                            for s in detected],
               "sectors": sectors}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", required=True,
                    help="reference-format .pth beside meta/settings.json")
    ap.add_argument("wavs", nargs="+", help="stereo wav files")
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    ap.add_argument("--out", default=None, help="write JSONL here")
    args = ap.parse_args(argv)

    settings = load_settings_near_checkpoint(args.checkpoint)
    if settings is None:
        raise SystemExit("no meta/settings.json found near the checkpoint")
    kind = family(settings)
    if kind == "passive":
        raise SystemExit("the waveform models (active, auralnet) are served; "
                         "the passive model needs precomputed features")
    cfg = config_from_settings(settings)
    model = load_model(args.checkpoint, cfg, args.device, kind=kind)

    pairs = [read_stereo_wav(p, cfg.fs) for p in args.wavs]
    wavL = np.stack([p[0] for p in pairs])
    wavR = np.stack([p[1] for p in pairs])
    with matmul_precision(settings.get("MATMUL_PRECISION", "default")):
        out = predict(model, wavL, wavR)
    probs, aoa, distp = (a.cpu().numpy() for a in out)

    sink = open(args.out, "w") if args.out else sys.stdout
    try:
        for rec in records(args.wavs, probs, aoa, distp, args.threshold):
            sink.write(json.dumps(rec) + "\n")
    finally:
        if args.out:
            sink.close()


if __name__ == "__main__":
    main()
