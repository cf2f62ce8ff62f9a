"""On the card: each cell runs through the benchmark's command, at the
benchmark's window length, and prints a correct result with its metrics.
"""

import json
import subprocess
import sys

import pytest
from conftest import ROOT

from pb import harness

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_the_cell_runs_correct_on_the_card(card, name, trace):
    seconds = harness.load_spec()["run_seconds"]
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name,
                          "--seed", str(2**31 + 4242), "--seconds", str(seconds),
                          "--trace", str(trace)], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    cell = harness.Cell(harness.load_spec(), name)
    want = cell.per_layer if trace else cell.end_to_end
    assert {m["name"] for m in want} <= set(res["metrics"])
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
