"""Device time from ``torch.profiler``: busy time, time by operation and
the longest idle gaps.

``trace`` follows ``biear_tpu_torch/serve/profile_serve.py::
device_profile`` (a copy; nothing of the port is imported): the device
ops of a traced call summed by name, busy time against the traced wall
time. It adds the union of the device intervals (busy seconds) and the
idle gaps between them, each named by the innermost host op that was
running at its middle.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def trace(fn, top: int = 10) -> dict:
    """Run fn() once under torch.profiler (CPU and CUDA), ending in a
    synchronise. Returns {"wall_s", "busy_s", "ops": {name: [seconds,
    count]}, "device_ops" (the `top` names by seconds),
    "idle_gaps" (the `top` longest gaps as [host op, seconds])}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    dev, cpu = [], []
    ops = {}
    for e in prof.events():
        r = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((r.start, r.end))
            o = ops.setdefault(e.name, [0.0, 0])
            o[0] += (r.end - r.start) * 1e-6
            o[1] += 1
        else:
            cpu.append((r.start, r.end, e.name))
    busy, gaps = _busy_and_gaps(dev)
    named = []
    for g0, g1 in gaps[:top]:
        mid = 0.5 * (g0 + g1)
        inside = [c for c in cpu if c[0] <= mid <= c[1]]
        name = (max(inside, key=lambda c: c[0])[2] if inside
                else "no traced host op")
        named.append([name, (g1 - g0) * 1e-6])
    best = sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_s": wall, "busy_s": busy, "ops": ops,
            "device_ops": [[k[:120], v[0]] for k, v in best],
            "idle_gaps": named}


def _busy_and_gaps(intervals: list):
    """(seconds covered by the union of [start, end] microsecond
    intervals, the gaps between them, longest first)."""
    if not intervals:
        return 0.0, []
    a = np.array(sorted(intervals), dtype=np.float64)
    ends = np.maximum.accumulate(a[:, 1])
    starts = a[1:, 0]
    gap = starts - ends[:-1]
    busy = (ends[-1] - a[0, 0]) - gap[gap > 0].sum()
    order = np.argsort(-gap)
    gaps = [(ends[i], starts[i]) for i in order if gap[i] > 0]
    return busy * 1e-6, gaps


def op_mean_s(ops: dict, fragment: str):
    """(mean seconds, count) of the device ops whose name holds
    `fragment`, or None."""
    hits = [v for k, v in ops.items() if fragment in k]
    n = sum(v[1] for v in hits)
    return None if n == 0 else (sum(v[0] for v in hits) / n, n)


def stage_busy_ms(fn) -> float:
    """Device busy milliseconds of one eager call of fn (after one
    untraced call)."""
    fn()
    return trace(fn)["busy_s"] * 1e3
