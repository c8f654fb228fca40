"""Metrics registry: the real-profiler counterpart of the reference's
Statistic table (include/Staistics.h:6-41 [sic]).

The port's own copy of `Statistic` and `op_modmul_count` from
`homulator_tpu/stats.py`, unchanged, and `torch_counters`, the
counterpart of its `xla_counters`: XLA reads HBM bytes, buffer sizes and
flops off a compiled executable; the port runs eagerly, so it counts one
run of the op instead (`OpCosts`, below). It reports no FLOPs_compiled:
no compiler counts the op's operations, and `op_modmul_count` already
gives its modular multiplies.

The reference counts per-unit busy cycles, memory stalls, HBM beats, SPM
words, and NoC transfers, then dumps a sorted table at end of run. Here the
same surface reports wall-clock kernel timings, op counts, and modeled
data-movement volumes; `show()` prints the sorted table (Staistics.h:30-36
parity) and `to_json()` emits machine-readable output.

`span` marks the op graph's own boundaries (an op, a key-switch phase, a
workload step) for the span recorder at the end of this module: what each
one cost on the host and on the device, and which kernels it launched.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from collections import Counter, defaultdict
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from . import kernels


class Statistic:
    def __init__(self) -> None:
        self.counters: Dict[str, float] = defaultdict(float)
        self.timings: Dict[str, list] = defaultdict(list)

    def increase(self, key: str, amount: float = 1.0) -> None:
        self.counters[key] += amount

    def set(self, key: str, value: float) -> None:
        self.counters[key] = value

    @contextmanager
    def timer(self, key: str):
        t0 = time.perf_counter()
        yield
        self.timings[key].append(time.perf_counter() - t0)

    def record_time(self, key: str, seconds: float) -> None:
        self.timings[key].append(seconds)

    # ---- reporting -------------------------------------------------------
    def table(self) -> str:
        lines = ["%-40s %16s" % ("stat", "value")]
        for k in sorted(self.counters):
            lines.append("%-40s %16.0f" % (k, self.counters[k]))
        for k in sorted(self.timings):
            ts = self.timings[k]
            lines.append(
                "%-40s %13.3f ms (n=%d, min %.3f)"
                % (k + "_ms", 1e3 * sum(ts) / len(ts), len(ts), 1e3 * min(ts))
            )
        return "\n".join(lines)

    def show(self) -> None:
        print(self.table())

    def to_json(self) -> str:
        out = dict(self.counters)
        for k, ts in self.timings.items():
            out[k + "_ms_mean"] = 1e3 * sum(ts) / len(ts)
            out[k + "_ms_min"] = 1e3 * min(ts)
            out[k + "_count"] = len(ts)
        return json.dumps(out)


_aten = torch.ops.aten
# calls that move no bytes: allocations (views are func.is_view)
_ALLOCATIONS = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                _aten.new_empty, _aten.new_empty_strided, _aten.lift_fresh}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    s = t.untyped_storage()
    return (t.device, s.data_ptr()), s.nbytes()


class OpCosts(TorchDispatchMode):
    """The bytes one run of an op moves, counted, not measured.

    While `counting()`, every aten call adds the bytes of each tensor it
    reads and writes (operands plus outputs, op by op, as XLA's "bytes
    accessed"; views and allocations move none), and every kernel launch
    the bytes its wrapper declares (kernels.count). A kernel's plain
    version runs unobserved and adds its kernel's declaration instead
    (kernels.as_kernel), so an op counts the same bytes on the CPU and on
    the card. `arg_bytes` sums the storages read that the run did not make:
    the op's arguments and the tables it reads."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0
        self.paused = 0  # kernels.unobserved's depth
        self._made = set()
        self._args: Dict[tuple, int] = {}

    def _read(self, t: torch.Tensor) -> None:
        key, size = _storage(t)
        if key not in self._made:
            self._args[key] = size

    @property
    def arg_bytes(self) -> int:
        return sum(self._args.values())

    def kernel(self, reads, nbytes: int) -> None:
        """One kernel launch's declared traffic (kernels.declare)."""
        self.hbm_bytes += sum(_nbytes(t) for t in reads) + nbytes
        for t in reads:
            self._read(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if func.is_view:
            return out
        in_keys = {_storage(t)[0] for t in ins}
        if not self.paused and func.overloadpacket not in _ALLOCATIONS:
            self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
            for t in ins:
                self._read(t)
        self._made.update(k for k in (_storage(t)[0] for t in outs)
                          if k not in in_keys)
        return out

    @contextmanager
    def counting(self):
        """Count the block's aten calls and kernel launches."""
        if kernels.COSTS is not None:
            raise RuntimeError("an OpCosts count is already running")
        kernels.COSTS = self
        try:
            with self:
                yield self
        finally:
            kernels.COSTS = None


def torch_counters(run: Callable[[], torch.Tensor],
                   device: torch.device) -> Dict[str, float]:
    """Counters of one call of `run` (an op on `device`, returning its
    output tensor), named after the reference's Statistic surface as
    `xla_counters` names them:

      HBM_bytes      bytes the op's aten calls and kernels read and write,
                     counted (OpCosts), the same on the CPU and the card
      MEM_arg_bytes  the op's tensor arguments and the tables it reads
      MEM_out_bytes  its output
      MEM_temp_bytes on the card only: the caching allocator's peak
                     during the call above what was allocated when it
                     began (the arguments and tables among it), less the
                     output; absent on the CPU, which has no such
                     allocator statistics

    `run` is called twice: once to build what it builds on first use
    (tables, keys, the kernel library), then once counted."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    run()
    costs = OpCosts()
    if cuda:
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    with costs.counting():
        out = run()
    out_bytes = _nbytes(out)
    res = {"HBM_bytes": float(costs.hbm_bytes),
           "MEM_arg_bytes": float(costs.arg_bytes),
           "MEM_out_bytes": float(out_bytes)}
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        res["MEM_temp_bytes"] = float(peak - before - out_bytes)
    return res


def op_modmul_count(op: str, n: int, level: int, alpha: int, dnum_used: int) -> int:
    """Analytic modmul counts per op (for roofline accounting).

    NTT/iNTT of one limb: ~(log2(n)/2 + 1) * n constant multiplies.
    """
    logn = n.bit_length() - 1
    ntt_cost = (logn // 2 + logn - logn // 2) * (n // 2) + n  # butterflies + mid
    l, a = level, alpha
    if op in ("hadd", "hsub", "padd"):
        return 0
    if op == "pmult":
        return 2 * l * n
    if op in ("hmult", "hsquare", "hrotate"):
        beta = -(-l // a)
        ks_ntt = l + beta * (l + a) + 2 * (a + l)  # modup intt+ntt, moddown per k
        ks_bconv = beta * (l + a) * min(a, l) + 2 * l * a
        ks_ip = 2 * beta * (l + a)
        total = ks_ntt * ntt_cost + (ks_bconv + ks_ip) * n
        if op in ("hmult", "hsquare"):
            # tensor + relin add (hsquare saves one tensor multiply)
            total += (5 if op == "hmult" else 4) * l * n
            total += 2 * ((l - 1) * n + 2 * ntt_cost)  # rescale both components
        return total
    raise ValueError(op)


# ---- spans ---------------------------------------------------------------

@dataclasses.dataclass(eq=False, slots=True)
class Span:
    """One recorded span. index: its place in the record, in the order the
    spans opened; parent: the index of the span it opened in (same
    thread), None at the top level; request: the number of its top-level
    span among the record's top-level spans (one a request where the
    request is one call of an op); host_start_ns / host_end_ns:
    `time.perf_counter_ns()` at open and close (the close 0 while open);
    timed: whether it takes a CUDA event pair (not under an untimed span);
    launches: the port's kernel launches by wrapper name while it was the
    innermost open span (kernels.count); device_start_ms /
    device_end_ms: when its two events passed on the device, in ms after
    the record's first event, filled by `spans()`, None on the CPU and
    where untimed."""

    name: str
    index: int
    parent: Optional[int]
    request: int
    host_start_ns: int
    host_end_ns: int = 0
    timed: bool = True
    launches: Counter = dataclasses.field(default_factory=Counter)
    device_start_ms: Optional[float] = None
    device_end_ms: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) * 1e-6

    @property
    def device_ms(self) -> Optional[float]:
        """From its first event to its second on the device: its device
        work, and any time the device waited for the host within it."""
        if self.device_start_ms is None:
            return None
        return self.device_end_ms - self.device_start_ms

    @property
    def device_kernels(self) -> int:
        """Device kernels its launches ran (kernels.KERNELS_PER_LAUNCH)."""
        return sum(n * kernels.KERNELS_PER_LAUNCH.get(k, 1)
                   for k, n in self.launches.items())


class SpanRecorder:
    """The spans of one record, with one stack of open spans a thread.
    While a span is open anywhere, `kernels.SPANS` holds the recorder, so
    each launch is credited to the innermost span open in the launching
    thread."""

    def __init__(self):
        self.spans: List[Span] = []
        self.requests = 0
        # set where recording is off: the next span starts a new record
        self.stale = False
        self._open = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def clear(self) -> None:
        with self._lock:
            self.spans = []
            self.requests = 0
            self.stale = False

    def push(self, name: str, timed: bool = True) -> Span:
        t = time.perf_counter_ns()
        if self.stale:
            self.clear()
        stack = self._stack()
        parent = stack[-1] if stack else None
        with self._lock:
            if parent is None:
                request = self.requests
                self.requests += 1
            else:
                request = parent.request
                timed = timed and parent.timed
            sp = Span(name, len(self.spans),
                      None if parent is None else parent.index, request, t,
                      timed=timed)
            self.spans.append(sp)
            self._open += 1
            kernels.SPANS = self
        stack.append(sp)
        return sp

    def pop(self, sp: Span) -> None:
        sp.host_end_ns = time.perf_counter_ns()
        self._stack().pop()
        with self._lock:
            self._open -= 1
            if self._open == 0:
                kernels.SPANS = None

    def launch(self, name: str) -> None:
        """One launch of kernel wrapper `name` (kernels.count)."""
        stack = getattr(self._local, "stack", None)
        if stack:
            stack[-1].launches[name] += 1


SPANS = SpanRecorder()
# on inside a `recording()` block (tests, operators); also on while
# torch.profiler records
RECORDING = False
NO_SPAN = contextlib.nullcontext()
_profiler = torch.autograd.profiler


class _OpenSpan:
    """The context of one recorded span: its host times, where it is timed
    its CUDA event pair on the current stream (where CUDA is in use and
    the stream is not being captured into a graph) and, while the profiler
    records, a `record_function` range of its name, so a profiler trace
    shows the span with its kernels under it."""

    __slots__ = ("name", "timed", "span", "rf", "end")

    def __init__(self, name: str, timed: bool):
        self.name = name
        self.timed = timed

    def __enter__(self):
        self.span = sp = SPANS.push(self.name, self.timed)
        self.rf = self.end = None
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        if (sp.timed and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            start.record()
            sp.events = (start, self.end)
        return sp

    def __exit__(self, *exc):
        if self.end is not None:
            self.end.record()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        SPANS.pop(self.span)
        return False


def span(name: str, timed: bool = True):
    """`with span(name):` around one step of the op graph. Recorded while
    torch.profiler records or inside `recording()`; at every other time
    it costs this flag test and returns a shared empty context. An
    untimed span, and every span under it, takes no CUDA events: the
    device-paced ops are timed, the launch-paced workloads around them
    are not."""
    if RECORDING or _profiler._is_profiler_enabled:
        return _OpenSpan(name, timed)
    SPANS.stale = True
    return NO_SPAN


@contextmanager
def recording():
    """Record the block's spans, with or without the profiler; the block
    starts a new record. Read it with `spans()`."""
    global RECORDING
    SPANS.clear()
    RECORDING = True
    try:
        yield SPANS
    finally:
        RECORDING = False
        SPANS.stale = True


def spans() -> List[Span]:
    """The recorded spans, in the order they opened: those of the last
    profiler session or `recording()` block that recorded any. (A record
    begins with a `recording()` block, or with the first span after one
    ended or after a span site ran with recording off; a profiler session
    right after another, with no op between, adds to its record.) Where
    they carry CUDA events, synchronises first, fills each closed span's
    device_start_ms / device_end_ms (after the first such span's first
    event) and lets its events go."""
    out = list(SPANS.spans)
    timed = [s for s in out if s.events is not None and s.host_end_ns]
    if timed:
        torch.cuda.synchronize()
        ref = timed[0].events[0]
        for s in timed:
            s.device_start_ms = ref.elapsed_time(s.events[0])
            s.device_end_ms = ref.elapsed_time(s.events[1])
            s.events = None
    return out


def span_table(recorded: List[Span]) -> List[dict]:
    """Per span name, in the order the names first opened: calls, host and
    device self ms (a span's own time less its children's; device None on
    the CPU or where untimed) and the port's kernel launches."""
    child_host = defaultdict(float)
    child_dev = defaultdict(float)
    for s in recorded:
        if s.parent is not None:
            child_host[s.parent] += s.host_ms
            child_dev[s.parent] += s.device_ms or 0.0
    rows: Dict[str, dict] = {}
    for s in recorded:
        r = rows.setdefault(s.name, {"span": s.name, "calls": 0,
                                     "host_self_ms": 0.0,
                                     "device_self_ms": 0.0, "launches": 0})
        r["calls"] += 1
        r["host_self_ms"] += s.host_ms - child_host[s.index]
        r["launches"] += sum(s.launches.values())
        if s.device_ms is None:
            r["device_self_ms"] = None
        elif r["device_self_ms"] is not None:
            r["device_self_ms"] += s.device_ms - child_dev[s.index]
    return list(rows.values())
