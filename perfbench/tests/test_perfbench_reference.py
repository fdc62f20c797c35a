"""The plain reference against the port's CPU path at a tiny size, and
`correct` coming out false when the timed path is broken underneath.

Each run drives the whole harness (set-up, window, release, check) on
the CPU, skipping only the look for a card."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

sys.path.insert(0, tiny.ROOT)
from perfbench import faults, harness  # noqa: E402

# agreement of the port's CPU path with the reference at the tiny size
# (the port's eager CPU step: bfloat16 filterbank operands as the
# reference rounds them; Adam's change over three steps magnifies the
# small gradient components' rounding most)
SOUND = {"loss_gap": 1e-4, "grad_gap": 0.05, "change_gap": 0.15,
         "grad_diff": 0.02, "grad_gap_median": 1e-3,
         "grad_gap_q25": 1e-3,
         "change_gap_median": 1e-2}
CELLS = ["dual-train-b512", "auralnet-train-b512", "dual-train-b64-spirit"]


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    torch.set_num_threads(1)
    return tiny.make(str(tmp_path_factory.mktemp("tiny") / "b"))


def _run(cell, bench_dir, seed=11):
    out = harness.run(cell, seed, 0.2, False, "cpu", tiny.benchmark(),
                      bench_dir=bench_dir)
    out.pop("_log")
    out.pop("_check")
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_reference(cell, bench_dir):
    out = _run(cell, bench_dir)
    assert out["failed"] == 0 and out["attempted"] > 0
    for k, v in out["checks"].items():
        assert v["value"] <= SOUND[k], (k, v)


FAULTS = [(c, f) for c in CELLS for f in faults.FAULTS]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_makes_run_incorrect(cell, fault, bench_dir):
    with faults.plant(fault):
        out = _run(cell, bench_dir, seed=12)
    assert out["correct"] is False, out["checks"]
