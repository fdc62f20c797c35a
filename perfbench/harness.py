"""One run of one cell: find its files by name, drive it, read its
metrics, decide `correct`, and build the result line.

Files, all found by the names in ``BENCHMARK.json``:
  * ``perfbench/workloads/<cell>.json``: the cell (its configuration,
    traffic mix, chips, why, and the limits of its compared numbers);
  * ``perfbench/configs/<config>.json``: the model configuration;
  * ``perfbench/traffic/<traffic>.json``: the traffic mix's parameters,
    naming its driver ``perfbench/traffic/<driver>.py`` (class ``Cell``);
  * ``perfbench/metrics/<metric>.py``: one reader per metric, ``read(ctx)``
    -> a number, or None where it finds nothing to read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "biear_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def cell_files(cell: str, bench_dir: str = HERE) -> tuple:
    """(cell, configuration, traffic mix) of the cell named `cell`."""
    w = load_json(bench_dir, "workloads", f"{cell}.json")
    return (w, load_json(bench_dir, "configs", f"{w['config']}.json"),
            load_json(bench_dir, "traffic", f"{w['traffic']}.json"))


def driver(name: str, bench_dir: str = HERE):
    return load_module(os.path.join(bench_dir, "traffic", f"{name}.py"),
                       f"perfbench_traffic_{name}").Cell


def reader(name: str, bench_dir: str = HERE):
    return load_module(os.path.join(bench_dir, "metrics", f"{name}.py"),
                       "perfbench_metric_" + name.replace(".", "_")).read


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of `cell` reports: its end-to-end ones,
    or with `trace` its per-layer ones (those listing the cell, or
    without a list those that move an end-to-end metric it reports)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def process_start() -> float:
    """time.time() of this process's start (Linux), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def run(cell: str, seed: int, seconds: float, trace: bool, device,
        bench: dict | None = None, started: float | None = None,
        bench_dir: str = HERE, control: bool = False, probe=None) -> dict:
    """Drive one run of `cell` on `device`; returns the result line's
    dict (with "checks" last), under "_log" what goes to stderr and under
    "_check" the check's whole output. `control` runs the program at the
    precision below its configuration's (the traffic Cell's control path).
    `probe` () -> str describes the card's state right after the window."""
    started = time.time() if started is None else started
    bench = benchmark() if bench is None else bench
    w, conf, mix = cell_files(cell, bench_dir)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    Cell = driver(mix["driver"], bench_dir)
    c = Cell(conf, mix, seed, dev, control=control)
    t_setup = time.time()
    c.setup(seconds)
    # set-up's objects leave the collector's generations, so a collection
    # in the window scans only what the window makes
    gc.collect()
    gc.freeze()
    setup_s = time.time() - started
    phases = {"before_setup": t_setup - started,
              **getattr(c, "setup_phases", {})}
    ctx = {"kind": c.kind, "setup_s": setup_s, "device": dev,
           "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    if trace:
        ctx.update(c.traced())
    else:
        ctx["window"] = c.window(seconds)
    after = probe() if probe else ""
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if trace and hasattr(c, "stages"):
        ctx.update(c.stages())
    c.release()
    chk = c.check()
    ctx["check"] = chk
    if hasattr(c, "shapes"):
        ctx["shapes"] = c.shapes(chk.get("draws", []))
    limits = w["limits"]
    checks = {k: {"value": chk["values"][k], "limit": v}
              for k, v in limits.items()}
    readings = {k: v for k, v in chk["values"].items() if k not in limits}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    metrics = {}
    for m in metrics_of(bench, cell, trace):
        v = reader(m["name"], bench_dir)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    win = ctx.get("window", {})
    failed = int(win.get("failed", 0))
    out = {"correct": bool(correct),
           "attempted": int(win.get("attempted", 0)),
           "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": ctx["device_kind"],
                      "count": int(w["chips"]),
                      "memory_peak_bytes": int(peak)}}
    if trace:
        tr = ctx["trace"]
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["wall_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
        out["attempted"] = int(ctx.get("traced_steps", 0))
    out["_check"] = chk
    out["checks"] = checks
    out["_log"] = ["setup phases (s): " + json.dumps(phases),
                   "window: " + json.dumps(win.get("info", {})),
                   "card after the window: " + after,
                   "readings not compared: " + json.dumps(readings),
                   "check: " + json.dumps({k: v for k, v in chk.items()
                                           if k not in ("values", "draws", "leaves")})]
    out["_log"] += [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
                   for k, v in checks.items()]
    return out


def emit(out: dict) -> None:
    """Print the stderr lines, then the result line last on stdout."""
    log = out.pop("_log")
    out.pop("_check")
    print(json.dumps(out), flush=True)
    for line in log:
        print(line, file=sys.stderr, flush=True)
