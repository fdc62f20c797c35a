"""A tiny copy of the benchmark's files for CPU tests: the same drivers
and readers (linked), the configurations at a small width, and traffic
mixes of a few rows and taps."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)

TINY_MODEL = {"n_bands": 16, "latent_dim": 16, "ctrl_hidden": 16,
              "d_model": 16}
HRIR = {"azimuths": 8, "distances": [0.5, 1.0], "taps": 96}
TINY_MIX = {
    "anechoic-b512": {"driver": "train_chunk", "scene": "anechoic",
                      "batch": 2, "chunk_steps": 2, "hrir": HRIR,
                      "segments": 4, "segment_samples": 16000,
                      "checked_steps": 3, "traced_chunks": 1},
    "spirit-b64": {"driver": "train_chunk", "scene": "spirit", "batch": 2,
                   "chunk_steps": 2,
                   "brir": {"n_yaw": 4, "taps": 64,
                            "speakers": [[-1.0, 1.73], [0.0, 2.0],
                                         [1.0, 1.73]]},
                   "segments": 4, "segment_samples": 16000,
                   "checked_steps": 3, "traced_chunks": 1},
}


def load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load(ROOT, "BENCHMARK.json")


def make(dst: str) -> str:
    """Write the tiny copy into `dst` (links to the code, small JSON);
    returns `dst`."""
    for sub in ("configs", "workloads", "traffic", "metrics"):
        os.makedirs(os.path.join(dst, sub), exist_ok=True)
    for sub in ("traffic", "metrics"):
        for f in os.listdir(os.path.join(BENCH_DIR, sub)):
            if f.endswith(".py"):
                os.symlink(os.path.join(BENCH_DIR, sub, f),
                           os.path.join(dst, sub, f))
    for f in os.listdir(os.path.join(BENCH_DIR, "configs")):
        c = load(BENCH_DIR, "configs", f)
        c["model"].update(TINY_MODEL)
        with open(os.path.join(dst, "configs", f), "w") as out:
            json.dump(c, out)
    for name, mix in TINY_MIX.items():
        with open(os.path.join(dst, "traffic", f"{name}.json"), "w") as out:
            json.dump(mix, out)
    for f in os.listdir(os.path.join(BENCH_DIR, "workloads")):
        shutil.copy(os.path.join(BENCH_DIR, "workloads", f),
                    os.path.join(dst, "workloads", f))
    return dst
