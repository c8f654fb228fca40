"""The traced part of a `--trace 1` run and its reduction.

`profile_burst` runs a fixed number of requests of the cell under
torch.profiler (CPU and CUDA activities), each inside two spans of the
benchmark's own (`portbench.enqueue`: the call to its return;
`portbench.sync`: the wait in `torch.cuda.synchronize()`). The traced window
runs from the first enqueue span's start to the last sync span's end.

The reduction gives the device operations in that window (kernels, copies
and sets, each `(name, start_s, end_s)`), their union (`busy_s`), and the
`breakdown` of the result line: the operations that took most time, by
kernel function, and the longest idle gaps, named by the benchmark span the
host was in at the gap's middle.

What counts as glue: PyTorch's own device work, i.e. a kernel in its
namespaces (`at::`, `c10::`, cub and thrust) or a memcpy / memset. Every
other kernel is the port's, so a kernel the port adds later counts there
without an edit.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, List, Tuple

import torch

ENQUEUE = "portbench.enqueue"
SYNC = "portbench.sync"
GLUE_MARKS = ("at::", "c10::", "cub::", "thrust::", "at_cuda_detail::")
GAP_LABELS = {ENQUEUE: "host enqueueing the request",
              SYNC: "host waiting in synchronize",
              None: "harness between requests"}


@dataclasses.dataclass
class Profile:
    requests: int
    window_s: float
    ops: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]

    @property
    def busy(self) -> List[Tuple[float, float]]:
        return merge([(a, b) for _, a, b in self.ops])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)


def is_glue(name: str) -> bool:
    return (name.startswith(("Memcpy", "Memset"))
            or any(m in name for m in GLUE_MARKS))


def short_name(name: str) -> str:
    """A kernel's function name without return type, anonymous namespace,
    template arguments or parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("<", "("):
        if stop in name:
            name = name[:name.index(stop)]
    return name[:120]


def merge(intervals):
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def profile_burst(request: Callable[[int], torch.Tensor], n: int,
                  first: int) -> Profile:
    """Requests first .. first+n-1 under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for k in range(n):
            with record_function(ENQUEUE):
                request(first + k)
            with record_function(SYNC):
                torch.cuda.synchronize()
    return reduce_events(prof.events(), n)


def reduce_events(events, n: int) -> Profile:
    """torch.profiler's FunctionEvents -> Profile, times in seconds from
    the traced window's start, device operations clipped to the window."""
    host, dev = [], []
    for e in events:
        span = (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.name in (ENQUEUE, SYNC):
            # a span is also mirrored on the device's timeline as a user
            # annotation: only its host side counts
            if e.device_type != torch.autograd.DeviceType.CUDA:
                host.append((e.name,) + span)
        elif (e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)):
            dev.append((e.name,) + span)
    if not host:
        raise RuntimeError("the trace holds none of the benchmark's spans")
    t0 = min(a for _, a, _ in host)
    t1 = max(b for _, _, b in host)
    ops = [(name, max(a, t0) - t0, min(b, t1) - t0)
           for name, a, b in dev if b > t0 and a < t1]
    if not ops:
        raise RuntimeError("the trace holds no device operation")
    return Profile(n, t1 - t0, ops,
                   [(name, a - t0, b - t0) for name, a, b in host])


def breakdown(p: Profile) -> dict:
    """device_ops: the ten kernel functions that took most device time;
    idle_gaps: the idle time by what the host was doing, then the longest
    single gaps, ten entries in all; seconds over the traced window."""
    by_name = defaultdict(float)
    for name, a, b in p.ops:
        by_name[short_name(name)] += b - a
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    edges = [0.0] + [x for iv in p.busy for x in iv] + [p.window_s]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    totals = defaultdict(float)
    single = []
    for a, b in gaps:
        label = GAP_LABELS[_host_span_at(p.host, (a + b) / 2)]
        totals[label] += b - a
        single.append((f"{label}, one gap", b - a))
    idle = [(f"{k}, all gaps", v)
            for k, v in sorted(totals.items(), key=lambda kv: -kv[1])]
    idle += sorted(single, key=lambda kv: -kv[1])[:10 - len(idle)]
    return {"device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": [[k, v] for k, v in idle]}


def _host_span_at(host, t: float):
    for name, a, b in host:
        if a <= t <= b:
            return name
    return None
