"""The cell helrB.iter.b1024 and the `logreg_sigmoid3` mix: on the CPU at
small sizes, their drivers through the harness (correct against the plain
reference, wrong under the control), the HELR spans and the two rotation
readers (None without device times), and the manifest's entries; marked
`card`, one traced run of each at its own size on one GPU: correct, the
HELR step spans with device times, and every per-layer metric the cell
lists read as a number.

The mix `logreg_sigmoid3` has no cell of its own (setB.logreg's rate
spread past half its bound, PERF.md §7), so it runs under the entry of
setB.matvec64, the host-paced cell of the same configuration: the mix
picks the driver, the entry the metrics.

Imports no JAX: the `card` tests run on a CUDA GPU with
`python -m pytest --noconftest -m card portbench/tests/test_portbench_helr.py`.
"""

import importlib
import time
import types

import numpy as np
import pytest
import torch

from homulator_tpu_torch import stats
from portbench import control
from portbench.harness import cell, manifest, trace
from portbench.metrics import _spans

ROOT = manifest.ROOT
HELR, LOGREG = "helrB.iter.b1024", "setB.matvec64"
STEPS = ("helr_iteration", "helr_rowsum", "helr_replicate", "helr_sigmoid",
         "helr_gradient", "helr_update")
ROTATION = ("rotate_ms_per_req", "automorph_ms_per_req")
# set B's structure at N = 256: 128 slots, 8 rows x 16 features, 3 blocks
HELR_TINY = {"name": "helrB", "n": 256, "max_level": 12, "alpha": 4,
             "dnum": 3, "level": 11, "scale_bits": 29, "minibatch": 24,
             "features": 16, "inputs": 13, "blocks": 3,
             "gamma": 3.3333333333333335, "eta": -0.28175352512532087}
HELR_MIX = {"op": "helr_iter", "pool": 2, "samples": 2, "trace_requests": 2}
LOGREG_TINY = {"name": "setB", "n": 256, "max_level": 8, "alpha": 3,
               "dnum": 3, "level": 7, "scale_bits": 29}
LOGREG_MIX = {"op": "logreg_sigmoid3", "pool": 3, "samples": 2,
              "trace_requests": 2}
TINY = {HELR: (HELR_TINY, HELR_MIX), LOGREG: (LOGREG_TINY, LOGREG_MIX)}


def _read(name, rec):
    return cell.load_reader(ROOT, "per_layer", name)(rec)


@pytest.mark.parametrize("name", [HELR, LOGREG])
def test_tiny_run_is_correct_and_the_control_is_not(name):
    cfg, mix = TINY[name]
    seed = 2 ** 40 + 11
    r = cell.run_cell(ROOT, name, seed, 0.5, False, "cpu",
                      time.perf_counter(), config=cfg, mix=mix)
    assert r["correct"] and r["checks"]["outputs_checked"]["value"] >= 1
    c = control.control_run(ROOT, name, seed, 0.1, "cpu", cfg, mix)
    assert c["correct"] is False and c["checks"]["wrong_words"]["value"] > 0


def test_helr_spans_on_the_cpu():
    """The driver's requests under recording(): one helr_iteration span a
    request with its five steps, the rotations' spans inside them, and no
    device number from the two rotation readers (no device times)."""
    driver = importlib.import_module("portbench.drivers.helr_iter")
    inputs = driver.make_inputs(np.random.default_rng([3, 1]), HELR_TINY,
                                HELR_MIX)
    env = cell.Env(HELR_TINY, HELR_MIX, 3, "cpu", cell.Spans())
    request = driver.program(env, inputs)
    host = []
    with stats.recording():
        t0 = time.perf_counter()
        for k in range(2):
            a = time.perf_counter() - t0
            request(k)
            host.append((trace.ENQUEUE, a, time.perf_counter() - t0))
    p = trace.Profile(2, host[-1][2], [("bconv_kernel", 0.0, host[-1][2])],
                      host)
    rec = cell.Record(1.0, {}, None, 0, p,
                      types.SimpleNamespace(least_s=lambda: 0.0))
    spans = _spans.port_spans(rec)
    assert [s.name for s in spans if s.parent is None] == [STEPS[0]] * 2
    names = [s.name for s in spans]
    for step in STEPS:
        assert names.count(step) == 2, step
    # 4 row-sum, 4 replicating, 3 sample-sum rotations a request
    assert names.count("hrotate_graph") == 2 * 11
    assert names.count("automorph") == 2 * 11
    for n in ROTATION:
        assert _read(n, rec) is None, n


def test_rotation_readers_need_a_trace():
    rec = cell.Record(1.0, {}, None, 0, None,
                      types.SimpleNamespace(least_s=lambda: 0.0))
    for n in ROTATION:
        assert _read(n, rec) is None, n


def test_manifest_entries():
    man = manifest.load(ROOT)
    cells = {w["name"]: w for w in man["workloads"]}
    assert cells[HELR]["config"] == "helrB" and cells[HELR]["chips"] == 1
    assert cells[HELR]["traffic"] == "helr_iter"
    e2e = {m["name"] for m in manifest.metrics_of(man, "end_to_end", HELR)}
    assert e2e == {"requests_per_s", "request_ms_p95",
                   "device_mem_peak_GiB", "setup_s"}
    for m in man["per_layer"]:
        if m["name"] in ROTATION:
            assert m["workloads"] == [HELR]
            assert m["moves"] == "requests_per_s"


def test_least_work():
    from portbench.counts import logistic, work

    helr = importlib.import_module("portbench.drivers.helr_iter")
    cfg = manifest.config(ROOT, manifest.load(ROOT), "helrB")
    w = helr.work(cfg, {})
    # more than its four batch-8 products, less than 40 such products
    hm = work.hmult_batch(cfg["n"], cfg["level"], cfg["alpha"], 8)
    assert 4 * hm.least_s() < w.least_s() < 40 * hm.least_s()
    lr = logistic.logreg_sigmoid3(65536, 35, 15)
    assert lr.least_s() > 15 * logistic.rotate_add(65536, 35, 15).least_s()


@pytest.mark.card
@pytest.mark.parametrize("name", [HELR, LOGREG])
def test_traced_run_on_the_card(name):
    """One traced run at the cell's own size (the logreg mix at set B under
    setB.matvec64's entry): correct; every per-layer metric the entry
    lists read as a number; for HELR the step spans with their device
    times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels and the "
                    "benchmark's timers run only on the card")
    mix = (None if name == HELR else
           manifest.mix(ROOT, LOGREG_MIX["op"]))
    r = cell.run_cell(ROOT, name, 2 ** 31 + 41, 3.0, True, "cuda",
                      time.perf_counter(), mix=mix)
    man = manifest.load(ROOT)
    listed = {m["name"] for m in manifest.metrics_of(man, "per_layer", name)}
    print(name, {k: v["value"] for k, v in r["metrics"].items()},
          r["device"], r["reference_s"])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) == listed
    if name == HELR:
        spans = stats.SPANS.spans
        for step in STEPS:
            got = [s for s in spans if s.name == step]
            assert got and all(s.device_ms is not None for s in got), step
        for n in ROTATION:
            assert r["metrics"][n]["value"] > 0
