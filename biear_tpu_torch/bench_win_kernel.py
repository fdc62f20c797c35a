#!/usr/bin/env python
"""Window-extraction ladder: one library gather, the plain version and the
CUDA kernel, at the shape of ``tools/bench_win_kernel.py``.

    python -m biear_tpu_torch.bench_win_kernel [--batch 1024] [--pool 256] \\
        [--steps 20] [--windows 5] [--only cuda,plain] [--device cpu]

Counterpart of ``tools/bench_win_kernel.py``. It extracts X = 3 * batch
conv-input windows pool[row, off : off + 16384] with sample-granular
offsets from a padded pool of `pool` rows (segments of 16128 samples,
HRIRs of 256 taps: rows of 17,024 samples), made with numpy from seed 0
exactly as the JAX tool makes them. Variants:

  library   one advanced-indexing gather (the tool's ``xla`` row)
  plain     ``ops/window_gather.py::gather_windows_plain`` (row
            index_select, then ``torch.gather`` along the row)
  cuda      ``kernels/gather_windows.cu``, the kernel that stands for the
            tool's ``pallas_chunk8`` and ``pallas_aligned``

Each output holds the X windows of 16384 samples. Every variant is first
held bit for bit to numpy slicing of all X windows, then timed: on the
card with CUDA events (``kernels/time_kernels.py::cuda_ms``, median of
`windows` windows of `steps` calls), on the CPU by the host clock the
same way. One JSON line per variant: X, ms per call, GB/s of windows
written. A variant that fails prints its error and the run exits with
1 once every variant has had its turn. It runs on the card unless
``--device cpu`` is given; there the ``cuda`` row says that it cannot
run (the kernel takes CUDA tensors only), which is not a failure.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from .device import resolve_device
from .kernels.time_kernels import cuda_ms, tool_pool
from .ops.window_gather import (WIN, gather_windows_cuda,
                                gather_windows_plain)


def time_ms(fn, device: torch.device, steps: int, windows: int) -> float:
    """ms per call: CUDA events on the card, the host clock on the CPU;
    median over `windows` windows of `steps` calls."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            return cuda_ms(torch, fn, reps=windows, inner=steps)
    fn()
    ms = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        ms.append((time.perf_counter() - t0) * 1e3 / steps)
    return statistics.median(ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--pool", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--only", default=None,
                    help="comma-separated variants (library, plain, cuda)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    pool_np, rows_np, offs_np = tool_pool(args.batch, args.pool)
    X = rows_np.shape[0]
    pool3 = torch.tensor(pool_np, device=device).view(args.pool, -1, 128)
    rows = torch.tensor(rows_np, device=device)
    offs = torch.tensor(offs_np, device=device)
    flat = pool3.view(args.pool, -1)
    t = torch.arange(WIN, device=device)
    rows64, offs64 = rows.long(), offs.long()
    want = pool_np[rows_np[:, None], offs_np[:, None] + np.arange(WIN)]

    variants = {
        "library": lambda: flat[rows64[:, None], offs64[:, None] + t],
        "plain": lambda: gather_windows_plain(pool3, rows, offs),
        "cuda": lambda: gather_windows_cuda(pool3, rows, offs),
    }
    gb = X * WIN * 4 / 1e9
    only = args.only.split(",") if args.only else None
    failed = []
    for name, fn in variants.items():
        if only and name not in only:
            continue
        if name == "cuda" and device.type != "cuda":
            print(json.dumps({"part": "win:cuda", "not_run": "the kernel "
                              "takes CUDA tensors only"}), flush=True)
            continue
        try:
            got = fn().reshape(X, WIN).cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"{name} is not bit-exact: max error "
                                     f"{float(np.abs(got - want).max())}")
            ms = time_ms(fn, device, args.steps, args.windows)
            print(json.dumps({"part": f"win:{name}", "X": X, "ms": ms,
                              "GBps": gb / (ms / 1e3),
                              "device": card}), flush=True)
        except Exception as e:
            failed.append(name)
            print(json.dumps({"part": f"win:{name}", "error": str(e)[:2000]}),
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
