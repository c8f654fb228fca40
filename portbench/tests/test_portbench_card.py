"""On one CUDA GPU: a short run of each cell through the command, and the
control at the cell's own size (`python -m pytest portbench/tests -m
card`). Each skips on a machine without a card."""

import json
import os
import subprocess
import sys

import pytest

from portbench import control
from portbench.harness import manifest

ROOT = manifest.ROOT
CELLS = [w["name"] for w in manifest.load(ROOT)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, os.path.join("portbench", "run.py"), "--workload",
         cell, "--seed", str(2 ** 31 + 3), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert list(r)[-1] == "checks"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_wrong_at_cell_size(card, cell):
    r = control.control_run(ROOT, cell, 2 ** 31 + 5, 10.0, "cuda")
    assert r["correct"] is False
    assert r["checks"]["wrong_words"]["value"] > 0
