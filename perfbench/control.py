#!/usr/bin/env python3
"""Readings that set a cell's limits, on the card: the program's sound
runs, its control and planted faults, several seeds in one process.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3
        [--mode sound|control|fault:<name>] [--seconds S] [--out f.jsonl]

  * sound: the program as configured; its compared numbers are the lower
    readings;
  * control: the nearest precision below the configuration's float32
    products with TF32 off: the program's own TF32 path (MATMUL_PRECISION
    "tensorfloat32");
  * fault:<name>: a fault of ``perfbench/faults.py`` planted in the
    program.

The benchmark's own runs never run this. Each seed is one run of the
harness (``harness.run``: set-up, a window of --seconds, release, the
check and `correct`); one JSON line per seed, with every reading.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [os.path.dirname(HERE)] + [
    p for p in sys.path if os.path.abspath(p or ".") != HERE]


def reading(cell: str, seed: int, mode: str, seconds: float, device,
            bench_dir: str = HERE) -> dict:
    """One harness run of `cell` in `mode`: `correct`, the compared
    numbers, the readings not compared and each leaf's norms."""
    from perfbench import faults, harness

    ctx = (faults.plant(mode.split(":", 1)[1])
           if mode.startswith("fault:") else contextlib.nullcontext())
    with ctx:
        out = harness.run(cell, seed, seconds, False, device,
                          bench_dir=bench_dir, control=(mode == "control"))
    chk = out["_check"]
    return {"cell": cell, "seed": seed, "mode": mode,
            "correct": out["correct"], "values": chk["values"],
            "limits": {k: v["limit"] for k, v in out["checks"].items()},
            "leaves": chk.get("leaves")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="sound")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control readings need a CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = reading(args.workload, seed, args.mode, args.seconds, "cuda:0")
        print(json.dumps({k: v for k, v in rec.items() if k != "leaves"}),
              flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
