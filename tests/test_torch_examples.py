"""The port's examples (examples/*_torch.py) and workload programs
(scripts/bench_workload_torch.py, scripts/bench_logreg_torch.py --smoke)
run end to end on the CPU plain path as subprocesses and exit 0: each
asserts its own decrypt against the clear computation (1e-2), as the JAX
examples do (tests/test_examples.py). The bench scripts build the native
host core at first use."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script", [
    "examples/encrypted_dot_product_torch.py",
    "examples/encrypted_matvec_bsgs_torch.py",
    "examples/encrypted_logreg_torch.py",
    "scripts/bench_workload_torch.py --smoke",
    "scripts/bench_logreg_torch.py --smoke",
    "scripts/bench_logreg_torch.py --smoke --fused-hpip",
])
def test_port_program_runs(script):
    path, *flags = script.split()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, path), *flags, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
