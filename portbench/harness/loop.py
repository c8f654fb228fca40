"""The closed loop that makes the measured window, and its arithmetic.

One client: each request starts when the previous one has finished on the
device. A request's latency is read from two CUDA events on the stream,
recorded at the call and after its last launch: the device is idle at the
call (the loop synchronised after the previous request), so the start event
fires at once and the pair spans the call to the end of the request's
device work, on the device's clock. The host clock times the enqueue (the
call to its return) and the window, which lasts `seconds` or more.

On the CPU (tests only) both come from the host clock.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, List

import torch


@dataclasses.dataclass
class Window:
    """latency_ms: every request's latency; enqueue_s: every request's
    host enqueue span; window_s: start of the first request to the end of
    the last; kept: sampled outputs by request index, copied to the host;
    last: (index, output) of the last request."""

    latency_ms: List[float]
    enqueue_s: List[float]
    window_s: float
    kept: Dict[int, torch.Tensor]
    last: tuple

    @property
    def requests(self) -> int:
        return len(self.latency_ms)


def rate(n: int, window_s: float) -> float:
    """Requests completed over the window's whole length."""
    return n / window_s


def p95(values: List[float]) -> float:
    """The 95th percentile over all values (linear interpolation between
    order statistics, `statistics.quantiles`' inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


class CudaTimer:
    """Request latency from CUDA events on the current stream."""

    def __init__(self):
        self.a = torch.cuda.Event(enable_timing=True)
        self.b = torch.cuda.Event(enable_timing=True)

    def start(self):
        self.a.record()

    def stop(self):
        self.b.record()

    def sync_ms(self) -> float:
        torch.cuda.synchronize()
        return self.a.elapsed_time(self.b)


class HostTimer:
    """Request latency from the host clock (CPU runs in tests)."""

    def start(self):
        self.t = time.perf_counter()

    def stop(self):
        pass

    def sync_ms(self) -> float:
        return (time.perf_counter() - self.t) * 1e3


def closed_loop(request: Callable[[int], torch.Tensor], seconds: float,
                timer, keep: Dict[int, torch.Tensor],
                first: int = 0) -> Window:
    """Run requests first, first+1, .. until `seconds` have passed at the
    end of one. keep maps a request index to a host buffer its output is
    copied into, after the request, outside its latency."""
    lat: List[float] = []
    enq: List[float] = []
    kept: Dict[int, torch.Tensor] = {}
    i = first
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        timer.start()
        t0 = time.perf_counter()
        out = request(i)
        t1 = time.perf_counter()
        timer.stop()
        lat.append(timer.sync_ms())
        end = time.perf_counter()
        enq.append(t1 - t0)
        if i in keep:
            kept[i] = keep[i].copy_(out)
        i += 1
        if end >= deadline:
            break
    return Window(lat, enq, end - start, kept, (i - 1, out))
