"""The port's own spans (`homulator_tpu_torch.stats.span`) in a traced run,
placed on the profiled burst's clock; what the span readers share.

The port records its spans while torch.profiler records, so after a
`--trace 1` run its recorder holds the burst's spans: one top-level span a
request (the op or workload the driver calls), the phases and steps under
it. Each span has host times from `time.perf_counter_ns()`, the port's
launches made in it, and, on the card, under an op called directly (not
under a workload, which the port leaves untimed), the device times of a
CUDA event pair.

The burst's clock (`harness.trace.Profile`) is the profiler's, in seconds
from the traced window's start. Two alignments put the spans on it:

- host: request k's top-level span starts inside the k-th
  `portbench.enqueue` span, so the offset from the port's host clock is
  the largest (enqueue start - span start) over the requests; their
  spread (largest less smallest) is the residual. It holds the spread of
  the harness's own time from its enqueue span's start to the call.
- device: the top-level span's second event passes on the device right
  after the request's last operation (the loop synchronises after each
  request), so request k's offset from the events' clock is (its last
  device operation's end - that event), one a request. The offsets'
  spread is the residual: 0.4-9.4 us over most bursts on the card, but
  in some the trace's clock steps by 0.03-3.4 ms (its busy time then
  falls by up to the step), and a request more than STEP_S from the
  median keeps its spans' event pairs.

A span's device time is the device's busy time (the union of the trace's
operations) between its two events on the burst's clock: its own work,
without the device's waits for the host inside it.

Every function returns None where there is nothing to read: no trace (the
CPU), no spans (the control, or a port without the recorder), a count of
top-level spans other than the burst's requests, or no device times.

Under the profiler each span also costs the host its `record_function`
range, its bookkeeping and, where timed, its event pair: the host-side
readers (host self time, idle by span) read that cost with the port's own
work.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional

from portbench.harness.trace import ENQUEUE

# the phases of a key switch; every other span is a workload step
KEYSWITCH = ("modup", "inner_product", "moddown")
# the largest step of a request's device offset from the burst's median
# read as drift (0.4-9.4 us on the card); past it the trace's clock stepped
STEP_S = 20e-6


def port_spans(rec) -> Optional[list]:
    """The port's spans of the traced burst, one top-level span a
    request, or None."""
    if rec.profile is None:
        return None
    try:
        from homulator_tpu_torch import stats
        read = stats.spans
    except (ImportError, AttributeError):
        return None
    spans = read()
    tops = [s for s in spans if s.parent is None]
    if not spans or len(tops) != rec.profile.requests:
        return None
    return spans


def busy_between(busy, a: float, b: float) -> float:
    """Seconds of busy time (merged, sorted intervals: Profile.busy)
    inside [a, b]."""
    k = max(bisect.bisect_right(busy, (a,)) - 1, 0)
    t = 0.0
    for lo, hi in busy[k:]:
        if lo >= b:
            break
        t += max(0.0, min(hi, b) - max(lo, a))
    return t


def device_alignment(rec, spans) -> Optional[tuple]:
    """(offsets_s, residual_s): offsets_s[k], one a request, makes request
    k's device ms x 1e-3 the burst's seconds; the residual is their
    spread, how far the events' clock and the trace's drift apart over
    the burst. None without device times on every top-level span."""
    p = rec.profile
    tops = [s for s in spans if s.parent is None]
    starts = sorted(a for name, a, _ in p.host if name == ENQUEUE)
    if (not tops or len(starts) != len(tops)
            or any(s.device_end_ms is None for s in tops)):
        return None
    bounds = starts[1:] + [p.window_s]
    d = []
    for t, a, b in zip(tops, starts, bounds):
        ends = [e for _, s0, e in p.ops if a <= s0 < b]
        if not ends:
            return None
        d.append(max(ends) - t.device_end_ms * 1e-3)
    return d, max(d) - min(d)


def device_busy_ms(rec, spans) -> Optional[Dict[int, float]]:
    """Each timed span's device busy ms (by index), on the burst's clock.
    A request whose offset lies more than STEP_S from the burst's median
    (the trace's clock stepped inside or around it) keeps its spans' event
    pairs, its device waits within them included."""
    al = device_alignment(rec, spans)
    if al is None:
        return None
    off, busy = al[0], rec.profile.busy
    mid = statistics.median(off)
    out = {}
    for s in spans:
        if s.device_start_ms is None:
            continue
        o = off[s.request]
        out[s.index] = (s.device_ms if abs(o - mid) > STEP_S else
                        1e3 * busy_between(busy, s.device_start_ms * 1e-3 + o,
                                           s.device_end_ms * 1e-3 + o))
    return out


def device_ms_per_req(rec, names) -> Optional[float]:
    """The device busy ms inside the spans named `names`, summed over the
    burst, over its requests; None without device times."""
    spans = port_spans(rec)
    if spans is None:
        return None
    picked = [s for s in spans if s.name in names]
    busy = device_busy_ms(rec, spans)
    if not picked or busy is None or any(s.index not in busy
                                         for s in picked):
        return None
    return sum(busy[s.index] for s in picked) / rec.profile.requests


def host_self_ms(spans) -> Dict[int, float]:
    """Each span's host self ms: its own time less its children's."""
    self_ms = {s.index: s.host_ms for s in spans}
    for s in spans:
        if s.parent is not None:
            self_ms[s.parent] -= s.host_ms
    return self_ms


def host_self_ms_per_req(rec, keyswitch: bool) -> Optional[float]:
    """Host self ms a request of the key-switch phases (keyswitch) or of
    every other span."""
    spans = port_spans(rec)
    if spans is None:
        return None
    own = host_self_ms(spans)
    total = sum(own[s.index] for s in spans
                if (s.name in KEYSWITCH) == keyswitch)
    return total / rec.profile.requests


def alignment(rec, spans) -> Optional[tuple]:
    """(offset_s, residual_s): the port's perf_counter seconds plus
    offset_s are the burst's seconds; None where the burst's enqueue
    spans and the port's top-level spans differ in number."""
    enq = sorted(a for name, a, _ in rec.profile.host if name == ENQUEUE)
    tops = [s for s in spans if s.parent is None]
    if not tops or len(enq) != len(tops):
        return None
    d = [e - s.host_start_ns * 1e-9 for e, s in zip(enq, tops)]
    return max(d), max(d) - min(d)


def idle_gaps(p) -> List[tuple]:
    """The device's idle gaps in the traced window, as trace.breakdown
    finds them."""
    edges = [0.0] + [x for iv in p.busy for x in iv] + [p.window_s]
    return [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]


def idle_by_span(rec) -> Optional[Dict[str, float]]:
    """Device idle seconds in the burst by the innermost port span the host
    was in at each gap's middle (the rule of trace.breakdown), over the
    gaps whose middle lies in an enqueue span; "" collects those in no
    port span."""
    spans = port_spans(rec)
    if spans is None:
        return None
    al = alignment(rec, spans)
    if al is None:
        return None
    off = al[0]
    by_start = sorted(spans, key=lambda s: s.host_start_ns)
    starts = [s.host_start_ns * 1e-9 + off for s in by_start]
    by_index = {s.index: s for s in spans}
    enq = [(a, b) for name, a, b in rec.profile.host if name == ENQUEUE]
    out: Dict[str, float] = {}
    for a, b in idle_gaps(rec.profile):
        mid = (a + b) / 2
        if not any(ea <= mid <= eb for ea, eb in enq):
            continue
        # the span that opened last before mid, or the first of its
        # ancestors still open at mid
        k = bisect.bisect_right(starts, mid) - 1
        s = by_start[k] if k >= 0 else None
        while s is not None and s.host_end_ns * 1e-9 + off < mid:
            s = by_index.get(s.parent)
        name = s.name if s is not None else ""
        out[name] = out.get(name, 0.0) + b - a
    return out


def idle_ms_per_req(rec, keyswitch: bool) -> Optional[float]:
    """Device idle ms a request while the host was inside a key-switch
    phase span (keyswitch) or inside any other port span."""
    by = idle_by_span(rec)
    if by is None:
        return None
    s = sum(v for k, v in by.items() if k and (k in KEYSWITCH) == keyswitch)
    return 1e3 * s / rec.profile.requests
