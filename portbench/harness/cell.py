"""Run one cell once: load, set up, measure, check, report.

  1. Load the cell's entry in BENCHMARK.json, its configuration and mix.
  2. Set up: the inputs from the seed, the port's engine, keys and inputs
     (the mix's driver), one warm-up request on every pool entry and one
     more, the host buffers for the sampled outputs. `setup_s` runs from
     the process's start to here.
  3. Measure: the closed loop for `seconds`; with trace, then a burst of
     the mix's `trace_requests` requests under torch.profiler.
  4. Check and report: the memory peak, then, with the program's state
     freed, the plain reference's answer for every sampled request (drawn
     from the seed) and the last one; the metric readers; last the modules
     loaded, after everything the run imports, and the result line.

The comparison is exact: `wrong_words` counts the output words that differ
from the reference's, and must be 0.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import os
import subprocess
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import loop, manifest, trace
from ..counts.work import Work
from ..reference.ckks import RefCkks
from ..reference.params import get_params as ref_params

FORBIDDEN = ("jax", "jaxlib", "flax", "homulator_tpu")


class Spans:
    """Seconds spent in each named span of the benchmark's set-up."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t


@dataclasses.dataclass
class Env:
    """What a driver's set-up gets: the cell's configuration and mix, the
    run's seed (the port's engine draws its keys and encryptions from it),
    the device and the spans. The engine it makes lives as long as the
    Env, to the window's close, as a server keeps its context."""

    config: dict
    mix: dict
    seed: int
    device: str
    span: Spans
    eng: object = None

    def engine(self):
        from homulator_tpu_torch import workloads
        from homulator_tpu_torch.api import CkksEngine, get_params

        c = self.config
        params = get_params(c["n"], c["max_level"], c["alpha"],
                            c["scale_bits"])
        if self.device == "cuda":
            # the host engine (keys, encoding, encryption) on the native core
            self.eng = workloads.native_engine(params, self.seed, "cuda")
        else:
            self.eng = CkksEngine(params, self.seed, device=self.device)
        return self.eng


@dataclasses.dataclass
class Record:
    """What the metric readers read."""

    setup_s: float
    spans: Dict[str, float]
    window: loop.Window
    memory_peak_bytes: int
    profile: Optional[trace.Profile]
    work: Work


class RunError(RuntimeError):
    """A run that must print no result."""


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> Optional[str]:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None


def load_reader(root: str, section: str, name: str):
    """A metric's reader (`manifest.reader_file`)."""
    path = os.path.join(root, manifest.reader_file(section, name))
    spec = importlib.util.spec_from_file_location(
        f"{manifest.READERS[section]}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def flat(out: torch.Tensor) -> torch.Tensor:
    """An output's eval tiles [..., n2, n1] as the reference's flat rows."""
    return out.reshape(out.shape[:-2] + (-1,)).long()


def run_cell(root: str, name: str, seed: int, seconds: float, traced: bool,
             device: str, t0: float, *, config: Optional[dict] = None,
             mix: Optional[dict] = None,
             program: Optional[Callable] = None) -> dict:
    """One run of cell `name`; returns the result line's object. config
    and mix replace the cell's files (tests at small sizes); program
    replaces the driver's `program` (the control, `portbench/control.py`).
    Raises RunError if a module of JAX or of the JAX package is loaded at
    the end."""
    man = manifest.load(root)
    cell = manifest.cell(man, name)
    cfg = config or manifest.config(root, man, cell["config"])
    mx = mix or manifest.mix(root, cell["traffic"])
    driver = importlib.import_module(f"portbench.drivers.{mx['op']}")
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    spans = Spans()

    # ---- set-up
    inputs = driver.make_inputs(np.random.default_rng([seed, 1]), cfg, mx)
    env = Env(cfg, mx, seed, device, spans)
    request = (program or driver.program)(env, inputs)
    pool = driver.pool(mx)
    timer = loop.CudaTimer() if cuda else loop.HostTimer()
    with spans("warmup"):
        for i in range(pool + 1):
            timer.start()
            out = request(i)
            timer.stop()
            t_req = timer.sync_ms() * 1e-3
    first = pool + 1
    est = max(1, int(seconds / max(t_req, 1e-6)))
    draws = np.random.default_rng([seed, 2]).random(mx["samples"])
    keep = {first + int(f * est * 0.9): torch.empty(
        out.shape, dtype=out.dtype, pin_memory=cuda) for f in draws}
    del out
    setup_s = time.perf_counter() - t0

    # ---- measure
    win = loop.closed_loop(request, seconds, timer, keep, first)
    prof = None
    if traced:
        prof = trace.profile_burst(request, mx["trace_requests"],
                                   win.last[0] + 1)
    sync()
    mem = torch.cuda.max_memory_allocated() if cuda else 0

    # ---- check, with the program's state freed
    answers = dict(win.kept)
    answers[win.last[0]] = win.last[1].cpu()
    win.last = (win.last[0], None)
    del request, env
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = RefCkks(ref_params(cfg["n"], cfg["max_level"], cfg["alpha"],
                             cfg["scale_bits"]), seed, device)
    answer = driver.reference(ref, cfg, mx, inputs)
    want = {k: answer(k) for k in sorted({i % pool for i in answers})}
    wrong_words = wrong_outputs = 0
    for i, got in answers.items():
        w = want[i % pool]
        g = flat(got).to(w.device)
        bad_words = (int((g != w).sum()) if g.shape == w.shape
                     else w.numel())
        wrong_words += bad_words
        wrong_outputs += bad_words > 0
    ref_s = time.perf_counter() - t_ref

    rec = Record(setup_s, dict(spans.total), win, mem, prof,
                 driver.work(cfg, mx))
    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in manifest.metrics_of(man, section, name):
        v = load_reader(root, section, m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        raise RunError(f"modules of JAX or of the JAX package loaded: {bad}")
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": cell["chips"], "memory_peak_bytes": mem}
    if cuda:
        dev["power"] = power_limit()
    result = {"correct": wrong_words == 0 and len(answers) > 0,
              "attempted": win.requests, "failed": wrong_outputs,
              "metrics": metrics, "device": dev}
    if prof is not None:
        dev["busy_s"] = prof.busy_s
        dev["window_s"] = prof.window_s
        result["breakdown"] = trace.breakdown(prof)
    result["reference_s"] = ref_s
    result["checks"] = {
        "wrong_words": {"value": wrong_words, "limit": 0},
        "wrong_outputs": {"value": wrong_outputs, "limit": 0},
        "outputs_checked": {"value": len(answers), "at_least": 1}}
    return result
