#!/usr/bin/env python3
"""The host input pipeline's rate: the counterpart of
``tools/bench_input_pipeline.py``.

    python -m biear_tpu_torch.bench_input_pipeline [--rows 4096]
        [--batch-size 64] [--epochs 2] [--workdir DIR] [--json PATH]
        [--device cpu]

Writes random splits of ``--rows`` rows at the reference row geometry and
reports epoch throughput in rows/s of ``data.pipeline.batch_iterator``
(shuffled, padded to full batches) over:

  shard       ``data/shard.ShardDataset`` on the active schema (2 x 16000
              int16 waveforms, 100 f32 CC, 56 f32 labels) and on the
              passive one (five 19 x 100 f32 planes, CC, labels): numpy
              memmap reads, one cold epoch, then ``--epochs`` warm ones;
              and the warm epochs through ``data.pipeline.Prefetcher``
              to the device (pinned host memory, copies on a side stream;
              a synchronize ends the epoch);
  h5_lazy     ``data/h5io.ActiveH5Dataset(preload=False)``, where h5py
  h5_preload  imports; otherwise each is reported as "unavailable: no
              h5py", never left out. The preload's one-off cost is
              reported apart.

The files go to ``--workdir`` (default: a temporary directory, removed
afterwards). Runs against the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import tempfile
import time

import numpy as np
import torch

from .bench import synchronizer
from .data.pipeline import Prefetcher, batch_iterator
from .data.shard import ShardDataset, write_shard
from .device import resolve_device

NO_H5PY = "unavailable: no h5py"
N_BANDS, TIMESTEPS = 100, 19


def epoch_rate(ds, batch_size: int, epochs: int = 1, device=None,
               seed: int = 0) -> float:
    """rows/s of `epochs` shuffled epochs, each batch's first value read
    (on the host, or on `device` through a ``Prefetcher``)."""
    sync = synchronizer(device) if device is not None else (lambda: None)
    sink = torch.zeros((), device=device) if device is not None else 0.0
    rows = 0
    t0 = time.perf_counter()
    for e in range(epochs):
        it = batch_iterator(ds, batch_size, shuffle=True, seed=seed,
                            epoch=e)
        if device is None:
            for b in it:
                rows += b[0].shape[0]
                sink += float(b[0].flat[0])        # touch the rows
            continue
        pf = Prefetcher(it, device)
        try:
            for b in pf:
                rows += b[0].shape[0]
                sink = sink + b[0].reshape(-1)[0]
        finally:
            pf.close()
    sync()
    return rows / (time.perf_counter() - t0)


def shard_rates(path: str, shapes, batch_size: int, epochs: int,
                device) -> dict:
    t0 = time.perf_counter()
    ds = ShardDataset(path, shapes=shapes)
    out = {"open_s": time.perf_counter() - t0,
           "bytes": os.path.getsize(path)}
    # the cold epoch pulls pages off the disk; warm epochs time the gather
    out["cold_rows_per_s"] = epoch_rate(ds, batch_size, 1)
    out["rows_per_s"] = epoch_rate(ds, batch_size, epochs)
    out["prefetch_rows_per_s"] = epoch_rate(ds, batch_size, epochs, device)
    return out


def h5_rates(rows: tuple, path: str, batch_size: int, epochs: int) -> dict:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return {"h5_lazy_rows_per_s": NO_H5PY,
                "h5_preload_rows_per_s": NO_H5PY, "h5_preload_s": NO_H5PY}
    from .data.h5io import ActiveH5Dataset, save_active_h5
    save_active_h5(path, *rows)
    out = {"h5_bytes": os.path.getsize(path)}
    ds = ActiveH5Dataset(path, preload=False)
    out["h5_lazy_rows_per_s"] = epoch_rate(ds, batch_size, epochs)
    ds.close()
    t0 = time.perf_counter()
    ds = ActiveH5Dataset(path, preload=True)
    out["h5_preload_s"] = time.perf_counter() - t0
    out["h5_preload_rows_per_s"] = epoch_rate(ds, batch_size, epochs)
    ds.close()
    return out


def run(rows: int = 4096, fs: int = 16000, batch_size: int = 64,
        epochs: int = 2, workdir: str | None = None, device=None) -> dict:
    """The bench's JSON; the splits are written to `workdir` (default: a
    temporary directory, removed afterwards)."""
    device = resolve_device(device)
    tmp = workdir is None
    workdir = tempfile.mkdtemp(prefix="biear_input_bench_") if tmp else workdir
    os.makedirs(workdir, exist_ok=True)
    try:
        rng = np.random.default_rng(0)
        wavL = rng.uniform(-1, 1, (rows, fs)).astype(np.float32)
        wavR = rng.uniform(-1, 1, (rows, fs)).astype(np.float32)
        x3 = rng.standard_normal((rows, N_BANDS)).astype(np.float32)
        y = rng.standard_normal((rows, 56)).astype(np.float32)
        planes = [rng.standard_normal((rows, TIMESTEPS, N_BANDS))
                  .astype(np.float32) for _ in range(4)]
        act = os.path.join(workdir, "active.shard")
        pas = os.path.join(workdir, "passive.shard")
        write_shard(act, [wavL, wavR, x3, y], ["i16", "i16", "f32", "f32"])
        write_shard(pas, [planes[0], planes[1], x3, planes[2], planes[3],
                          y])
        tb = (TIMESTEPS, N_BANDS)
        out = {"rows": rows, "fs": fs, "batch_size": batch_size,
               "epochs": epochs,
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
               "shard_active": shard_rates(
                   act, [(fs,), (fs,), (N_BANDS,), (56,)], batch_size,
                   epochs, device),
               "shard_passive": shard_rates(
                   pas, [tb, tb, (N_BANDS,), tb, tb, (56,)], batch_size,
                   epochs, device)}
        out.update(h5_rates((wavL, wavR, x3, y),
                            os.path.join(workdir, "active.h5"), batch_size,
                            epochs))
    finally:
        if tmp:
            shutil.rmtree(workdir, ignore_errors=True)
    out["max_rss_mb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1024
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--fs", type=int, default=16000)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)
    out = run(args.rows, args.fs, args.batch_size, args.epochs, args.workdir,
              args.device)
    text = json.dumps(out, indent=2)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
