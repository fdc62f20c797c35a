"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as new files only: nothing existing is edited."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

sys.path.insert(0, tiny.ROOT)
from perfbench import harness  # noqa: E402


def test_new_files_only(tmp_path):
    d = tiny.make(str(tmp_path / "b"))
    before = {os.path.join(r, f): open(os.path.join(r, f), "rb").read()
              for r, _, fs in os.walk(d) for f in fs}
    # a new configuration: the flagship with its single-controller sibling
    conf = tiny.load(d, "configs", "biear-dual.json")
    conf["name"] = "biear-dual-wide"
    conf["model"]["ctrl_hidden"] = 24
    json.dump(conf, open(os.path.join(d, "configs", "biear-dual-wide.json"),
                         "w"))
    # a new traffic mix for the existing driver
    mix = dict(tiny.TINY_MIX["anechoic-b512"], batch=3)
    json.dump(mix, open(os.path.join(d, "traffic", "anechoic-b3.json"), "w"))
    # a new cell and a new per-layer metric
    json.dump({"config": "biear-dual-wide", "traffic": "anechoic-b3",
               "chips": 1, "why": "a test cell",
               "limits": {"loss_gap": 1e-3, "grad_gap": 0.05,
                          "change_gap": 0.2}},
              open(os.path.join(d, "workloads", "wide-b3.json"), "w"))
    open(os.path.join(d, "metrics", "traced_steps.py"), "w").write(
        "def read(ctx):\n    return ctx.get('traced_steps')\n")
    bench = tiny.benchmark()
    bench["configs"].append({"name": "biear-dual-wide", "source": "x",
                             "file": "perfbench/configs/x.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "wide-b3", "config": "biear-dual-wide",
                               "traffic": "anechoic-b3", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_utt_s":
            m["workloads"].append("wide-b3")
    bench["per_layer"].append({"name": "traced_steps", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "Test", "moves": "train_utt_s",
                               "workloads": ["wide-b3"]})
    out = harness.run("wide-b3", 5, 0.2, True, "cpu", bench, bench_dir=d)
    out.pop("_log")
    assert out["metrics"]["traced_steps"]["value"] == 2
    assert out["correct"] is True
    after = {p: open(p, "rb").read() for p in before}
    assert after == before
