"""The metric arithmetic on synthetic timings and traces: the rate over the
whole window, the 95th percentile over all requests, the trace's busy
union, idle share, glue split and breakdown."""

import statistics
import types

import pytest
import torch

from portbench.harness import cell, loop, trace
from portbench.harness.manifest import ROOT

E2E = ("requests_per_s", "request_ms_p95", "setup_s", "device_mem_peak_GiB")
LAYER = ("keygen_s", "host_enqueue_ms_per_req", "launches_per_req",
         "glue_ms_per_req", "port_kernels_ms_per_req", "request_roofline",
         "device_idle_pct")


def test_rate_is_over_the_whole_window():
    assert loop.rate(300, 20.0) == 15.0
    assert loop.rate(301, 20.5) == pytest.approx(14.6829, abs=1e-4)


def test_p95_is_over_all_requests():
    lat = [10.0] * 95 + [50.0] * 5 + [100.0]
    # statistics' inclusive quantile: position 0.95 * 100 = 95 -> 50.0
    assert loop.p95(lat) == 50.0
    lat = list(range(1, 201))
    assert loop.p95([float(x) for x in lat]) == pytest.approx(190.05)
    assert loop.p95([3.0]) == 3.0
    # not a median of chunk medians: one slow chunk shows in full
    lat = [1.0] * 90 + [9.0] * 10
    assert loop.p95(lat) == 9.0
    assert statistics.median([statistics.median(lat[i:i + 10])
                              for i in range(0, 100, 10)]) == 1.0


def _profile():
    ops = [("void at::native::vectorized_elementwise_kernel<4, F>(int, F)",
            0.000, 0.004),
           ("void ntt_fwd_radix_a<5>(unsigned int const*)", 0.003, 0.006),
           ("Memcpy DtoD (Device -> Device)", 0.007, 0.008),
           ("void at::native::reduce_kernel<512, 1>(R)", 0.012, 0.015),
           ("bconv_kernel", 0.016, 0.018)]
    host = [(trace.ENQUEUE, 0.0, 0.009), (trace.SYNC, 0.009, 0.0095),
            (trace.ENQUEUE, 0.0105, 0.017), (trace.SYNC, 0.017, 0.020)]
    return trace.Profile(2, 0.020, ops, host)


def test_trace_reduction():
    p = _profile()
    assert p.busy == [(0.0, 0.006), (0.007, 0.008), (0.012, 0.015),
                      (0.016, 0.018)]
    assert p.busy_s == pytest.approx(0.012)
    assert trace.is_glue(p.ops[0][0]) and trace.is_glue(p.ops[2][0])
    assert not trace.is_glue(p.ops[1][0]) and not trace.is_glue("bconv_kernel")
    assert trace.short_name(p.ops[0][0]) == \
        "at::native::vectorized_elementwise_kernel"
    b = trace.breakdown(p)
    assert b["device_ops"][0] == ["at::native::vectorized_elementwise_kernel",
                                  pytest.approx(0.004)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    gaps = {k.split(",")[0]: v for k, v in b["idle_gaps"] if "all" in k}
    # gaps: .006-.007 (enqueue), .008-.012 (mid .010: the harness),
    # .015-.016 (enqueue), .018-.020 (sync)
    assert gaps["host enqueueing the request"] == pytest.approx(0.002)
    assert gaps["harness between requests"] == pytest.approx(0.004)
    assert gaps["host waiting in synchronize"] == pytest.approx(0.002)


def _record(profile):
    win = loop.Window([10.0, 12.0, 30.0], [0.001, 0.002, 0.003], 0.06, {},
                      (2, None))
    work = types.SimpleNamespace(least_s=lambda: 0.0006)
    return cell.Record(42.0, {"keygen": 1.5, "encrypt": 2.0}, win,
                       3 * 2 ** 30, profile, work)


def test_readers():
    rec = _record(_profile())
    read = {n: cell.load_reader(ROOT, "end_to_end", n)(rec) for n in E2E}
    assert read["requests_per_s"] == pytest.approx(50.0)
    assert read["request_ms_p95"] == pytest.approx(28.2)
    assert read["setup_s"] == 42.0 and read["device_mem_peak_GiB"] == 3.0
    read = {n: cell.load_reader(ROOT, "per_layer", n)(rec) for n in LAYER}
    assert read["keygen_s"] == 1.5
    assert read["host_enqueue_ms_per_req"] == pytest.approx(2.0)
    assert read["launches_per_req"] == 2.5
    assert read["glue_ms_per_req"] == pytest.approx((4 + 1 + 3) / 2)
    assert read["port_kernels_ms_per_req"] == pytest.approx((3 + 2) / 2)
    assert read["request_roofline"] == pytest.approx(100 * 0.6 / 6.0)
    # 50 req/s in the window, 6 ms busy a request: 30% busy
    assert read["device_idle_pct"] == pytest.approx(70.0)


def test_host_paced_entries_read_as_their_base():
    rec = _record(_profile())
    for section, names in (("end_to_end", ("requests_per_s",)),
                           ("per_layer", LAYER[1:])):
        for n in names:
            assert cell.load_reader(ROOT, section, n + ".host_paced")(rec) \
                == cell.load_reader(ROOT, section, n)(rec), n


def test_readers_without_a_trace_return_nothing():
    rec = _record(None)
    for n in LAYER[2:]:
        assert cell.load_reader(ROOT, "per_layer", n)(rec) is None


def test_reduce_events_keeps_device_work_only():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, dev, a, b, annotation=False):
        return types.SimpleNamespace(
            name=name, device_type=dev, is_user_annotation=annotation,
            time_range=types.SimpleNamespace(start=a, end=b))

    events = [ev(trace.ENQUEUE, cpu, 100, 150), ev(trace.SYNC, cpu, 150, 190),
              # the span mirrored on the device's timeline
              ev(trace.ENQUEUE, cuda, 100, 190, annotation=True),
              ev("aten::mul", cpu, 101, 102),
              ev("void (anonymous namespace)::ntt_fwd_radix_a<5>(int)", cuda,
                 120, 160),
              ev("void at::native::elementwise_kernel<128, 4>(int)", cuda,
                 165, 185),
              ev("Memcpy HtoD", cuda, 10, 20)]
    p = trace.reduce_events(events, 1)
    assert [n for n, _, _ in p.ops] == [events[4].name, events[5].name]
    assert p.window_s == pytest.approx(90e-6)
    assert p.busy_s == pytest.approx(60e-6)
    assert trace.short_name(events[4].name) == "ntt_fwd_radix_a"
