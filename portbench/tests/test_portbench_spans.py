"""The readers of the port's spans (`metrics/_spans.py` and the eight
metrics on it): on synthetic spans and traces, the alignment of the two
clocks and its None case, the idle gaps by innermost span, host self
time, and None on the CPU and under the control; at small sizes on the CPU
through the driver's own program; and, marked `card`, each hmult cell's
traced burst on one GPU, its spans against the device trace."""

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
from portbench.tests.tiny import MIXES, TINY

ROOT = manifest.ROOT
DEVICE = ("tensor_ms_per_req", "modup_ms_per_req", "inner_product_ms_per_req",
          "moddown_ms_per_req")
HOST = ("keyswitch_host_ms_per_req", "workload_host_ms_per_req")
IDLE = ("idle_in_keyswitch_ms_per_req", "idle_in_workload_ms_per_req")
T = 5000.0  # the port's clock at the burst's start, seconds


DEV = 3.0  # the events' clock, ms, less the burst's clock, ms


def _span(index, name, parent, request, a, b, device=None):
    """A span from a to b ms after T on the port's clock, its events at
    device = (start, end) ms on the burst's clock."""
    start, end = (None, None) if device is None else \
        (device[0] + DEV, device[1] + DEV)
    return stats.Span(name, index, parent, request,
                      round((T + a * 1e-3) * 1e9), round((T + b * 1e-3) * 1e9),
                      device_start_ms=start, device_end_ms=end)


def _spans_two_requests(device=True):
    """Two requests: an op with a ModUp, an automorph and a ModDown; the
    first's op starts as its enqueue span does (at 0 ms on the burst's
    clock), the second's 0.5 ms after its own (21 ms). On the device each
    op's second event passes as its request's last operation ends (24.8
    and 40 ms)."""
    def dev(a, b):
        return (a, b) if device else None
    return [_span(0, "op", None, 0, 0.0, 9.0, dev(0.0, 24.8)),
            _span(1, "modup", 0, 0, 2.0, 4.0, dev(2.0, 6.0)),
            _span(2, "automorph", 0, 0, 5.0, 6.0, dev(9.0, 10.0)),
            _span(3, "moddown", 0, 0, 6.0, 8.0, dev(6.0, 9.0)),
            _span(4, "op", None, 1, 21.5, 29.5, dev(24.9, 40.0)),
            _span(5, "modup", 4, 1, 23.5, 25.5, dev(25.0, 30.0)),
            _span(6, "moddown", 4, 1, 26.5, 28.5, dev(30.0, 36.0))]


def _profile():
    """Enqueue spans at 0-10 and 21-30 ms, the device busy but for gaps
    around 3 ms (in the first request's modup), 5.5 ms (its automorph),
    8.7 ms (the op alone: its ModDown span closes at 8), 9.5 ms (no port
    span: the op closes at 9), 15 ms (in synchronize) and 25 ms (the
    second request's modup)."""
    ops = [("void at::native::vectorized_elementwise_kernel<4>(int)",
            0.0000, 0.0028),
           ("void ntt_fwd_radix_a<5>(int)", 0.0032, 0.0053),
           ("bconv_kernel", 0.0057, 0.0086),
           ("void at::native::elementwise_kernel<128, 4>(int)", 0.0088,
            0.0094),
           ("void at::native::elementwise_kernel<128, 4>(int)", 0.0096,
            0.0140),
           ("void at::native::elementwise_kernel<128, 4>(int)", 0.0160,
            0.0248),
           ("void ntt_fwd_radix_a<5>(int)", 0.0252, 0.0400)]
    host = [(trace.ENQUEUE, 0.0, 0.010), (trace.SYNC, 0.010, 0.020),
            (trace.ENQUEUE, 0.021, 0.030), (trace.SYNC, 0.030, 0.040)]
    return trace.Profile(2, 0.040, ops, host)


def _record(profile):
    return cell.Record(10.0, {}, None, 0, profile,
                       types.SimpleNamespace(least_s=lambda: 0.0))


def _read(name, rec):
    return cell.load_reader(ROOT, "per_layer", name)(rec)


@pytest.fixture
def recorded(monkeypatch):
    """Make the port's recorder return the given spans."""
    def use(spans):
        monkeypatch.setattr(stats, "spans", lambda: list(spans))
    return use


def test_alignment_offset_and_residual(recorded):
    spans = _spans_two_requests()
    rec = _record(_profile())
    off, residual = _spans.alignment(rec, spans)
    # enqueue start - span start: -T and 21 ms - T - 21.5 ms
    assert off == pytest.approx(-T, abs=1e-9)
    assert residual == pytest.approx(0.0005, abs=1e-9)
    # no top-level span starts before its enqueue span
    for s, (_, a, _) in zip([s for s in spans if s.parent is None],
                            [h for h in rec.profile.host
                             if h[0] == trace.ENQUEUE]):
        assert s.host_start_ns * 1e-9 + off >= a - 1e-9


def test_alignment_none_when_the_counts_differ(recorded):
    spans = _spans_two_requests()[:4]  # one request's spans
    rec = _record(_profile())
    assert _spans.alignment(rec, spans) is None
    recorded(spans)
    # the profile has two requests, the recorder one top-level span
    assert _spans.port_spans(rec) is None
    for n in DEVICE + HOST + IDLE:
        assert _read(n, rec) is None, n


def test_idle_gaps_go_to_the_innermost_span(recorded):
    recorded(_spans_two_requests())
    rec = _record(_profile())
    by = _spans.idle_by_span(rec)
    assert by["modup"] == pytest.approx(0.0004 + 0.0004)  # 2.8-3.2, 24.8-25.2
    assert by["automorph"] == pytest.approx(0.0004)  # 5.3-5.7
    assert by["op"] == pytest.approx(0.0002)  # 8.6-8.8
    assert by[""] == pytest.approx(0.0002)  # 9.4-9.6: no port span
    # 14-16 ms lies in synchronize: no enqueue span, not counted
    assert sum(by.values()) == pytest.approx(0.0016)
    assert _read("idle_in_keyswitch_ms_per_req", rec) == \
        pytest.approx(0.8 / 2)
    assert _read("idle_in_workload_ms_per_req", rec) == \
        pytest.approx(0.6 / 2)
    assert _read("idle_in_keyswitch_ms_per_req.host_paced", rec) == \
        pytest.approx(0.4)


def test_host_self_time(recorded):
    spans = _spans_two_requests()
    own = _spans.host_self_ms(spans)
    assert own[0] == pytest.approx(9.0 - 2.0 - 1.0 - 2.0)
    assert own[4] == pytest.approx(8.0 - 2.0 - 2.0)
    assert own[1] == pytest.approx(2.0)
    recorded(spans)
    rec = _record(_profile())
    ks = _read("keyswitch_host_ms_per_req", rec)
    wl = _read("workload_host_ms_per_req.host_paced", rec)
    assert ks == pytest.approx((2 + 2 + 2 + 2) / 2)
    assert wl == pytest.approx((4 + 1 + 4) / 2)
    # together the requests' whole host time in the port
    assert ks + wl == pytest.approx((9.0 + 8.0) / 2)


def test_device_alignment_offset_and_residual():
    spans = _spans_two_requests()
    rec = _record(_profile())
    off, residual = _spans.device_alignment(rec, spans)
    assert off == pytest.approx([-DEV * 1e-3] * 2, abs=1e-12)
    assert residual == pytest.approx(0.0, abs=1e-12)
    # the events' clock runs 1 us ahead by the second request: its own
    # offset places its spans
    for s in spans[4:]:
        s.device_start_ms += 0.001
        s.device_end_ms += 0.001
    off, residual = _spans.device_alignment(rec, spans)
    assert off == pytest.approx([-DEV * 1e-3, -DEV * 1e-3 - 1e-6],
                                abs=1e-12)
    assert residual == pytest.approx(1e-6, abs=1e-12)
    assert _spans.device_busy_ms(rec, spans)[5] == pytest.approx(4.8)
    # a step of 1 ms: each request lies 0.5 ms off the median and keeps
    # its event pairs
    for s in spans[4:]:
        s.device_start_ms += 1.0
        s.device_end_ms += 1.0
    busy = _spans.device_busy_ms(rec, spans)
    assert [busy[k] for k in range(7)] == pytest.approx(
        [24.8, 4.0, 1.0, 3.0, 15.1, 5.0, 6.0])
    # a top-level span without device times: no alignment
    spans[0].device_end_ms = None
    assert _spans.device_alignment(rec, spans) is None


def test_busy_between():
    busy = [(0.0, 1.0), (2.0, 3.0), (4.0, 6.0)]
    assert _spans.busy_between(busy, 0.5, 5.0) == pytest.approx(2.5)
    assert _spans.busy_between(busy, 1.0, 2.0) == 0.0
    assert _spans.busy_between(busy, 2.5, 2.6) == pytest.approx(0.1)
    assert _spans.busy_between(busy, 7.0, 8.0) == 0.0


def test_device_phases(recorded):
    """A phase's device time is the busy time between its events, the
    idle gaps inside it left out."""
    recorded(_spans_two_requests())
    rec = _record(_profile())
    # modup 2-6 ms: busy 2-2.8, 3.2-5.3, 5.7-6; 25-30 ms: busy 25.2-30
    assert _read("modup_ms_per_req", rec) == pytest.approx((3.2 + 4.8) / 2)
    # moddown 6-9 ms: busy 6-8.6, 8.8-9; 30-36 ms: all busy
    assert _read("moddown_ms_per_req", rec) == pytest.approx((2.8 + 6) / 2)
    # no such span in these requests
    assert _read("tensor_ms_per_req", rec) is None
    assert _read("inner_product_ms_per_req", rec) is None
    # each request's device busy time lies inside its op span
    busy = _spans.device_busy_ms(rec, _spans_two_requests())
    assert busy[0] + busy[4] == pytest.approx(1e3 * rec.profile.busy_s)


def test_no_device_number_without_device_times(recorded):
    """On the CPU the spans carry no CUDA events: the device readers read
    nothing, never the host clock."""
    recorded(_spans_two_requests(device=False))
    rec = _record(_profile())
    for n in DEVICE:
        assert _read(n, rec) is None, n
    assert _read("keyswitch_host_ms_per_req", rec) == pytest.approx(4.0)


def test_nothing_without_a_trace_or_a_recorder(recorded, monkeypatch):
    recorded(_spans_two_requests())
    for n in DEVICE + HOST + IDLE:
        assert _read(n, _record(None)) is None, n
    # a port without the recorder (the parent of the spans)
    monkeypatch.delattr(stats, "spans")
    for n in DEVICE + HOST + IDLE:
        assert _read(n, _record(_profile())) is None, n


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_nothing_under_the_control(mix):
    """The control in the program's place records no port span."""
    name, mx = MIXES[mix]
    with stats.recording():
        r = control.control_run(ROOT, name, 2 ** 31 + 21, 0.1, "cpu", TINY,
                                mx)
    assert r["correct"] is False
    assert stats.spans() == []
    for n in DEVICE + HOST + IDLE:
        assert _read(n, _record(_profile())) is None, n


def _driver_burst(mix):
    """The tiny mix's program on the CPU, a burst of its trace_requests
    inside recording(), each in an enqueue span of the port's clock; the
    device trace a synthetic busy stretch."""
    name, mx = MIXES[mix]
    driver = importlib.import_module(f"portbench.drivers.{mx['op']}")
    inputs = driver.make_inputs(np.random.default_rng([5, 1]), TINY, mx)
    env = cell.Env(TINY, mx, 5, "cpu", cell.Spans())
    request = driver.program(env, inputs)
    request(0)
    host = []
    with stats.recording():
        t0 = time.perf_counter()
        for k in range(mx["trace_requests"]):
            a = time.perf_counter() - t0
            request(k)
            host.append((trace.ENQUEUE, a, time.perf_counter() - t0))
    window = host[-1][2]
    p = trace.Profile(len(host), window, [("bconv_kernel", 0.0, window)],
                      host)
    return _record(p)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_driver_spans_on_the_cpu(mix):
    """The port's spans of the driver's own requests: one top-level span a
    request, the host readers' sum the enqueue spans' within 5%, and no
    device number on the CPU."""
    rec = _driver_burst(mix)
    spans = _spans.port_spans(rec)
    top = {"hmult": "hmult_graph", "matvec": "matvec_bsgs"}[mix]
    assert [s.name for s in spans if s.parent is None] == [top] * 2
    assert {s.name for s in spans} >= {"modup", "inner_product", "moddown"}
    host = sum(_read(n, rec) for n in HOST)
    enqueue = 1e3 * sum(b - a for _, a, b in rec.profile.host) / 2
    assert host == pytest.approx(enqueue, rel=0.05)
    assert _spans.alignment(rec, spans)[1] < 0.002
    for n in DEVICE:
        assert _read(n, rec) is None, n
    # the device is never idle in this trace
    assert _read("idle_in_keyswitch_ms_per_req", rec) == 0.0


@pytest.mark.card
@pytest.mark.parametrize("name", ["setB.hmult.b8", "setC.hmult.b8"])
def test_spans_account_for_the_hmult_burst(card, name):
    """A hmult cell traced on the card: (a) the four phase metrics plus the
    op spans' own device time are within 3% of the busy time a request;
    (b) the port launches credited to spans equal the device trace's
    non-glue operations, exactly. Prints both alignments' residuals (the
    host's also without the burst's first request) and where each top
    span starts after its enqueue span does."""
    from homulator_tpu_torch import kernels

    seed = 2 ** 31 + 29
    man = manifest.load(ROOT)
    entry = manifest.cell(man, name)
    cfg = manifest.config(ROOT, man, entry["config"])
    mx = manifest.mix(ROOT, entry["traffic"])
    driver = importlib.import_module(f"portbench.drivers.{mx['op']}")
    inputs = driver.make_inputs(np.random.default_rng([seed, 1]), cfg, mx)
    env = cell.Env(cfg, mx, seed, "cuda", cell.Spans())
    request = driver.program(env, inputs)
    for i in range(driver.pool(mx) + 1):
        request(i)
    torch.cuda.synchronize()
    prof = trace.profile_burst(request, mx["trace_requests"], 100)
    rec = _record(prof)
    spans = _spans.port_spans(rec)
    assert spans is not None
    n = prof.requests
    phases = sum(_read(m, rec) for m in DEVICE)
    busy = _spans.device_busy_ms(rec, spans)
    child = {}
    for s in spans:
        if s.parent is not None:
            child[s.parent] = child.get(s.parent, 0.0) + busy[s.index]
    tops = [s for s in spans if s.parent is None]
    op_self = sum(busy[s.index] - child.get(s.index, 0.0) for s in tops) / n
    busy_ms = 1e3 * prof.busy_s / n
    off, host_res = _spans.alignment(rec, spans)
    dev_off, dev_res = _spans.device_alignment(rec, spans)
    mid = sorted(dev_off)[len(dev_off) // 2]
    stepped = sum(abs(o - mid) > _spans.STEP_S for o in dev_off)
    enq = sorted(a for h, a, _ in prof.host if h == trace.ENQUEUE)
    after = [1e6 * (t.host_start_ns * 1e-9 + off - e)
             for t, e in zip(tops, enq)]
    credited = sum(s.device_kernels for s in spans)
    port_ops = sum(1 for o, _, _ in prof.ops if not trace.is_glue(o))
    print(f"{name}: phases {phases:.4f} + op self {op_self:.4f} ms "
          f"against busy {busy_ms:.4f} ms a request "
          f"({100 * (phases + op_self) / busy_ms - 100:+.3f}%); "
          f"residual host {1e6 * host_res:.2f} us, without the first "
          f"request {max(after[1:]) - min(after[1:]):.2f} us, device "
          f"{1e6 * dev_res:.2f} us ({stepped} requests past the step); top "
          f"span after enqueue start, us: "
          f"{[round(a, 2) for a in after]}; credited kernels {credited} "
          f"= non-glue operations {port_ops}")
    assert phases + op_self == pytest.approx(busy_ms, rel=0.03)
    assert credited == port_ops
    assert sum(s.launches.get("ntt_fwd", 0) for s in spans) \
        * kernels.KERNELS_PER_LAUNCH["ntt_fwd"] == \
        sum(1 for o, _, _ in prof.ops if "ntt_fwd_radix" in o)
