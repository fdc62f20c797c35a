"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import os
import re
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

sys.path.insert(0, tiny.ROOT)
from perfbench import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = tiny.benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(tiny.ROOT, "BENCHMARK.json")) <= 65536


def _entries():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[kind]:
            yield kind, e


@pytest.mark.parametrize("kind,entry", list(_entries()),
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_entry(kind, entry):
    assert NAME.match(entry["name"])
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[kind]
    extra = set(entry) - keys
    assert extra <= ({"workloads"} if kind in ("end_to_end", "per_layer")
                     else set())
    assert keys <= set(entry)
    for k in ("why", "layer", "source"):
        if k in entry:
            assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k]
    if kind == "configs":
        path = os.path.join(tiny.ROOT, entry["file"])
        assert entry["file"].startswith("perfbench/") and os.path.exists(path)
        assert tiny.load(path)["source"] == entry["source"]
    if kind == "workloads":
        assert entry["chips"] == 1
        w, conf, mix = harness.cell_files(entry["name"])
        assert (w["config"], w["traffic"]) == (entry["config"],
                                               entry["traffic"])
        assert os.path.exists(os.path.join(tiny.BENCH_DIR, "traffic",
                                           mix["driver"] + ".py"))
        assert w["why"] == entry["why"] and w["limits"]
    if kind in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"]) and entry["better"] in (
            "lower", "higher")
        assert os.path.exists(os.path.join(tiny.BENCH_DIR, "metrics",
                                           entry["name"] + ".py"))
        cells = {w["name"] for w in BENCH["workloads"]}
        assert set(entry.get("workloads", cells)) <= cells
    if kind == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if kind == "per_layer":
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        assert entry["moves"] in e2e
        moved = e2e[entry["moves"]].get("workloads")
        assert moved is None or set(entry["workloads"]) <= set(moved)
        if entry["name"].endswith("_roofline") or "mfu" in entry["name"]:
            assert entry["unit"] == "%"


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e = harness.metrics_of(BENCH, w["name"], False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.metrics_of(BENCH, w["name"], True)


def test_every_config_used_and_layers_named_alike():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_result_line_schema(tmp_path):
    d = tiny.make(str(tmp_path / "b"))
    out = harness.run("dual-train-b512", 2 ** 31 + 7, 0.3, False, "cpu",
                      BENCH, bench_dir=d)
    log = out.pop("_log")
    assert list(out)[-1] == "checks" and log
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert set(out["metrics"]) == {"train_utt_s", "setup_s"}
    assert out["device"]["count"] == 1 and out["attempted"] > 0
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}
