#!/usr/bin/env python3
"""Streaming-serving profile on the card: per-hop cost of ``stream_step``
for concurrent streams, with and without stream churn.

    python -m biear_tpu_torch.serve.profile_stream [--seed 0] [--out f.json]

Counterpart of ``tools/bench_streaming.py`` and
``tools/bench_streaming_soak.py``. One hop is win = hop = 842 samples,
52.6 ms of audio at 16 kHz; the batch is the number of concurrent
streams: BATCHES for each mode of MODES, under the bf16 policy. Per
(mode, batch, churn) it reports:

  * host_ms: p50 / p95 host-clock time of one synchronised stream_step
    over REPS hops (what a loop that waits for each hop sees);
  * event_ms_per_hop: CUDA events around chains of K and 2K hops issued
    back to back, (T(2K) - T(K)) / K with K = CHAIN, median of 3 (K
    doubles while the difference is not positive);
  * kernels per hop (``launches_per_hop``), the host's launches per hop
    (kernel and graph launches, async copies and fills), device-busy ms
    per hop and the idle share of the traced wall time (torch.profiler
    over a few hops);
  * real-time factor = hop duration / ms per hop (host p50 and chained),
    and streams per card = batch x the chained real-time factor.

Churn: each stream ends with probability 1/19 per hop (one 1 s utterance
on average) and ``stream_reset`` (a masked fill) re-initialises its slot
before the next ``stream_step``: the counterpart of the soak's jitted
``stream_reset`` + ``stream_step``. The hop is the path users get, the
model's captured graph per batch (its capture ms and the pool's bytes
are reported per model under "graphs"). Seeded random weights
(geometries as ``profile_serve.GEOMETRY``); needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from ..graph import pool_stats
from ..models import BiEARConfig, build_active
from .profile_serve import GEOMETRY, device_profile
from .streaming import stream_init, stream_plan, stream_reset, stream_step

CHURN_P = 1.0 / 19.0
BATCHES = (1, 8, 64, 512)
MODES = ("dual", "single")
POLICY = "bfloat16"
CHAIN = 16
REPS = 30


class Streams:
    """Concurrent streams on the card: a state, one hop of audio per
    stream, and a generator for the churn draws."""

    def __init__(self, model, batch: int, churn: bool, seed: int = 0,
                 capture=None):
        self.model, self.churn, self.capture = model, churn, capture
        self.state = stream_init(model, batch)
        hop = stream_plan(model.cfg)["hop"]
        gen = torch.Generator(device="cuda").manual_seed(seed)
        self.chunks = [torch.rand((batch, hop), generator=gen,
                                  device="cuda") * 2 - 1 for _ in range(2)]
        self.gen = gen
        self.batch = batch

    def hop(self):
        if self.churn:
            ended = torch.rand(self.batch, generator=self.gen,
                               device="cuda") < CHURN_P
            self.state = stream_reset(self.model, self.state, ended)
        self.state = stream_step(self.model, self.state, *self.chunks,
                                 capture=self.capture)


def host_ms(streams: Streams, reps: int) -> list:
    streams.hop()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams.hop()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def chain_ms(streams: Streams, K: int) -> float:
    """CUDA-event time of K hops issued back to back."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(K):
        streams.hop()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def event_ms_per_hop(streams: Streams, chain: int):
    """(T(2K) - T(K)) / K, median of 3; K doubles (up to 8x) while the
    difference is not positive."""
    K = chain
    while True:
        d = statistics.median(chain_ms(streams, 2 * K) - chain_ms(streams, K)
                              for _ in range(3))
        if d > 0 or K >= 8 * chain:
            return d / K, K
        K *= 2


def profile(model, batch: int, churn: bool, hop_ms: float) -> dict:
    streams = Streams(model, batch, churn)
    host = host_ms(streams, REPS)
    ev, K = event_ms_per_hop(streams, CHAIN)
    prof = device_profile(streams.hop, calls=4, top=5)
    p50 = statistics.median(host)
    return {"batch": batch, "churn": churn,
            "host_ms_p50": p50,
            "host_ms_p95": statistics.quantiles(host, n=20)[18],
            "event_ms_per_hop": ev, "chain": K,
            "launches_per_hop": prof["kernels_per_call"],
            "host_launches_per_hop": prof["host_launches_per_call"],
            "device_busy_ms_per_hop": prof["device_busy_ms_per_call"],
            "device_idle_share": prof["device_idle_share"],
            "rtf_host": hop_ms / p50, "rtf_chained": hop_ms / ev,
            "streams_per_card": batch * hop_ms / ev,
            "top_kernels": prof["top"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_stream needs a CUDA card")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rows, graphs = [], {}
    for mode in MODES:
        cfg = BiEARConfig(**GEOMETRY[mode], fb_w_dtype=POLICY)
        plan = stream_plan(cfg)
        hop_ms = 1e3 * plan["hop"] / cfg.fs
        model = build_active(cfg, seed=args.seed)
        for batch in BATCHES:
            for churn in (False, True):
                row = profile(model, batch, churn, hop_ms)
                row["mode"] = mode
                rows.append(row)
                print(json.dumps({k: v for k, v in row.items()
                                  if k != "top_kernels"}), flush=True)
        graphs[mode] = pool_stats(model)
    result = {"card": smi, "policy": POLICY, "hop_ms": hop_ms,
              "churn_p": CHURN_P, "rows": rows, "graphs": graphs}
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(result, indent=1) + "\n")
    print(json.dumps({"card": smi, "policy": POLICY, "hop_ms": hop_ms}))


if __name__ == "__main__":
    main()
