"""Metric logging: JSONL always; TensorBoard when it imports.

Counterpart of ``biear_tpu/utils/logging.py``: per-step and per-epoch
scalars and per-tensor gradient histograms go to ``scalars.jsonl`` (one
JSON object per line) and are mirrored to TensorBoard when
``torch.utils.tensorboard`` imports. Histogram rows are named by the
port's parameter names, which are the reference checkpoints' names.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricLogger:
    def __init__(self, log_dir: str, tb_dir: str | None = None):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a",
                       buffering=1)
        self._tb = None
        if tb_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(tb_dir)

    def scalars(self, tag_prefix: str, values: dict, step: int):
        rec = {"t": time.time(), "step": step,
               **{f"{tag_prefix}/{k}": float(v) for k, v in values.items()}}
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(f"{tag_prefix}/{k}", float(v), step)

    def histograms(self, tag_prefix: str, hists: dict, edges, step: int):
        """hists maps a parameter name to its bucket counts over the shared
        magnitude `edges` (underflow first, overflow last)."""
        rec = {"t": time.time(), "step": step, "kind": "hist",
               "edges": [float(e) for e in edges],
               **{f"{tag_prefix}/{k}": [int(c) for c in v]
                  for k, v in hists.items()}}
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is None:
            return
        e = np.asarray(edges, np.float64)
        centers = (e[:-1] + e[1:]) / 2.0
        for k, v in hists.items():
            counts = np.asarray(v, np.float64)
            # len(edges) + 1 buckets; fold the flanks into the edge bins
            folded = counts[1:len(e)].copy()
            folded[0] += counts[0]
            folded[-1] += counts[len(e)]
            total = folded.sum()
            if total == 0:
                continue
            self._tb.add_histogram_raw(
                f"{tag_prefix}/{k}", min=float(e[0]), max=float(e[-1]),
                num=int(total), sum=float((folded * centers).sum()),
                sum_squares=float((folded * centers ** 2).sum()),
                bucket_limits=e[1:].tolist(),
                bucket_counts=folded.tolist(), global_step=step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()


class NullLogger:
    """The logger of a process that is not rank 0: the same interface, no
    file opened, nothing written."""

    def scalars(self, tag_prefix, values, step):
        pass

    def histograms(self, tag_prefix, hists, edges, step):
        pass

    def close(self):
        pass
