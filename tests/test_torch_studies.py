"""The port's op-study scripts on the CPU (no card: what they compute
besides the timings), against the JAX package where it has the same
function:

  * bench_parity36_torch.parity36_shape(65536, 45, 15, 35) equals the JAX
    script's, (56, 19, 43) with the same mean prime bits;
  * sweep_torch's record carries every key of the JAX sweep's lines
    (outLogs/B/hmult.jsonl), and its level subsets are the JAX script's;
  * bench_automorph_torch's one-hot automorphism equals the flat and the
    staged gathers (bf16 products on the CPU at n = 256);
  * script/run_torch.sh refuses an unknown set or op;
  * each new scripts/*_torch.py, loaded in a fresh interpreter, imports
    neither jax nor anything of the JAX package.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from homulator_tpu_torch.api import get_params
from homulator_tpu_torch.context import DeviceContext
from homulator_tpu_torch.ops.automorph import (
    automorph_eval, automorph_eval_staged,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_SCRIPTS = ("sweep_torch", "bench_batched_torch", "bench_hoisted_torch",
               "bench_parity36_torch", "profile_hrotate_torch",
               "bench_automorph_torch")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_parity36_shape_matches_jax():
    ours = _load("bench_parity36_torch").parity36_shape(65536, 45, 15, 35)
    theirs = _load("bench_parity36").parity36_shape(65536, 45, 15, 35)
    assert ours == theirs
    assert ours[:3] == (56, 19, 43)
    with open(os.path.join(ROOT, "PARITY36.json")) as f:
        shape = json.load(f)["parity_shape"]
    assert (shape["L"], shape["alpha"], shape["level"]) == ours[:3]


def test_sweep_record_has_the_jax_keys():
    sweep = _load("sweep_torch")
    assert sweep.PARAM_SETS == _load("sweep").PARAM_SETS
    assert sweep.OPS == _load("sweep").OPS
    rec = sweep.record("B", "hmult", 35, 3.5, 1.0, 5.0, "piecewise",
                       "card, 700.00 W")
    with open(os.path.join(ROOT, "outLogs", "B", "hmult.jsonl")) as f:
        jax_keys = set(json.loads(f.readline()))
    assert jax_keys <= set(rec)
    assert {k: rec[k] for k in ("set", "op", "n", "max_level", "level",
                                "alpha")} == {
        "set": "B", "op": "hmult", "n": 65536, "max_level": 45,
        "level": 35, "alpha": 15}
    assert set(rec) - jax_keys == {"eager_ms", "route", "card"}


@pytest.mark.parametrize("name,want", [
    ("A", [28, 21, 14, 7, 2]), ("B", [45, 35, 33, 22, 11, 2]),
    ("C", [24, 18, 12, 6, 2]), ("D", [26, 19, 13, 6, 2]),
    ("M", [28, 21, 14, 7, 2])])
def test_sweep_levels(name, want):
    sweep = _load("sweep_torch")
    assert sweep.levels_for(name, "auto") == want
    L = sweep.PARAM_SETS[name]["max_level"]
    assert sweep.levels_for(name, "all") == list(range(L, 1, -1))
    assert sweep.levels_for(name, [50, 20, 1]) == [20]


def test_onehot_automorph_equals_flat():
    bench = _load("bench_automorph_torch")
    p = get_params(n=256, max_level=2, alpha=1)
    dc = DeviceContext(p, "cpu")
    g = p.galois_elt(1)
    s1, s2, s3 = dc.automorph_stage_maps(g)
    oh1, oh3 = bench.onehot_tables(s1, s3, p.ntt.n2)
    assert oh1.dtype == torch.bfloat16 and oh1.shape == (16, 16, 16)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(3, 16, 16),
                                      dtype=np.int64).astype(np.int32))
    flat = automorph_eval(x, dc.automorph_perm(g))
    assert torch.equal(bench.onehot_auto(x, oh1, s2, oh3), flat)
    assert torch.equal(automorph_eval_staged(x, s1, s2, s3), flat)


@pytest.mark.parametrize("args", [["X", "hmult"], ["B", "hsquare"]])
def test_run_torch_usage(args):
    r = subprocess.run(["bash", os.path.join(ROOT, "script", "run_torch.sh"),
                        *args], capture_output=True, text=True, timeout=60)
    assert r.returncode == 1 and "usage" in r.stderr


@pytest.mark.parametrize("name", NEW_SCRIPTS)
def test_script_imports_no_jax(name):
    """Loading the script imports neither, and no import statement of it
    (main's included) names either."""
    with open(os.path.join(ROOT, "scripts", f"{name}.py")) as f:
        src = f.read()
    assert not re.search(r"^\s*(from|import)\s+(jax|homulator_tpu)\b", src,
                         re.M)
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location({name!r}, "
        f"'scripts/{name}.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert callable(mod.main)\n"
        "bad = sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'homulator_tpu'))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
