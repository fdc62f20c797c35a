#!/usr/bin/env python3
"""Run one cell of the benchmark once on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>
    (or python3 -m perfbench.run ...)

Set-up (inputs and weights from the seed, the program's graphs captured,
the checked steps) counts as ``setup_s``, from the process's start to the
window's; then the window runs for --seconds; --trace 1 runs a traced
window instead and reports the per-layer metrics and a breakdown. The
last line of standard output is the result's JSON; the compared numbers
and their limits are the last lines of standard error. Exits 2 without
enough CUDA cards, and 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(HERE, "_cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_ext"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(CACHE, "nv"))
os.environ.setdefault("USE_FLAX", "0")
# run as a script, Python puts this directory first on the path; the
# package's modules are imported as perfbench.* from the checkout's root
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") not in (HERE, ROOT)]


STATE = ("clocks.sm,clocks.mem,temperature.gpu,power.draw,"
         "clocks_throttle_reasons.active")


def card(query: str) -> str:
    """nvidia-smi's reading of `query` for the first card."""
    p = subprocess.run(["nvidia-smi", "--id=0", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return p.stdout.strip() or p.stderr.strip()


def main(argv=None) -> int:
    from perfbench import harness

    started = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    bench = harness.benchmark()
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    # the card's name, power limit and state are read after the window,
    # so that no nvidia-smi process runs in set-up
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", bench, started,
                      probe=lambda: card(STATE))
    print(f"card: {card('name,power.limit')}", file=sys.stderr, flush=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    harness.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
