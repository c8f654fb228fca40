"""The port's span recorder (`stats.span`, `stats.recording`, `stats.spans`)
on the CPU at small parameters: the span tree and request numbers of an
hmult batch, a rotation and a small BSGS matvec; nothing recorded and no
event made while recording is off; launches credited to the innermost span
with `kernels.LAUNCHES` still counting each; one stack a thread; the same
bits with recording on and off; a profiler session starting a new record;
the CUDA event path (with a stand-in event), no events inside a workload,
no spans on a sharded basis, the span table of the CLI and profiled_ms
leaving the spans' annotations out.""" 

import threading

import numpy as np
import pytest
import torch

from homulator_tpu_torch import api, cli, kernels, stats, workloads
from homulator_tpu_torch.api import CkksEngine, get_params

LEVEL, SCALE = 6, 2.0 ** 26
KEYSWITCH = ["modup", "inner_product", "moddown"]


@pytest.fixture(scope="module")
def eng():
    e = CkksEngine(get_params(256, 8, 4, 26), 7, device="cpu")
    e.keygen()
    return e


@pytest.fixture(scope="module")
def cts(eng):
    rng = np.random.default_rng(3)
    return [eng.encrypt_complex(rng.normal(size=128), LEVEL, SCALE)
            for _ in range(4)]


@pytest.fixture(scope="module")
def matvec(eng, cts):
    M = np.random.default_rng(4).normal(size=(8, 8)) / 8
    return workloads.matvec_prep(eng, M, LEVEL, SCALE, 4)


def _tree(spans):
    """(name, parent's name, request) of each span, in order."""
    by = {s.index: s for s in spans}
    return [(s.name, by[s.parent].name if s.parent is not None else None,
             s.request) for s in spans]


def _hmult_batch(eng, cts):
    kt = eng.dc.keyswitch_tables(LEVEL)
    a = torch.stack([cts[0].data, cts[1].data])
    b = torch.stack([cts[2].data, cts[3].data])
    return api.hmult_graph(a, b, eng.relin_key, kt)


@pytest.mark.parametrize("fused", [False, True])
def test_hmult_batch_span_tree(eng, cts, fused, monkeypatch):
    monkeypatch.setattr(api, "USE_FUSED_HPIP", fused)
    with stats.recording():
        _hmult_batch(eng, cts)
        _hmult_batch(eng, cts)
    spans = stats.spans()
    phases = ["tensor"] + KEYSWITCH
    assert _tree(spans) == [
        (name, parent, r) for r in (0, 1)
        for name, parent in [("hmult_graph", None)]
        + [(p, "hmult_graph") for p in phases]]
    assert [s.index for s in spans] == list(range(len(spans)))
    for s in spans:
        assert 0 < s.host_start_ns <= s.host_end_ns
        assert s.device_ms is None and s.events is None  # the CPU: no event
    # nested spans lie inside their parent on the host clock
    top = spans[0]
    for s in spans[1:5]:
        assert top.host_start_ns <= s.host_start_ns <= s.host_end_ns \
            <= top.host_end_ns


def test_rotation_span_tree(eng, cts):
    with stats.recording():
        eng.hrotate(cts[0], 1)
        eng.hrotate_hoisted(cts[0], [1, 2])
    assert _tree(stats.spans()) == [
        ("hrotate_graph", None, 0), ("automorph", "hrotate_graph", 0)] + [
        (p, "hrotate_graph", 0) for p in KEYSWITCH + ["rotation_add"]] + [
        ("hrotate_hoisted_graph", None, 1),
        ("modup", "hrotate_hoisted_graph", 1)] + 2 * [
        (p, "hrotate_hoisted_graph", 1)
        for p in ["automorph", "inner_product", "moddown", "automorph",
                  "rotation_add"]]


def test_matvec_span_tree(cts, matvec):
    """d = 8, g = 4: three hoisted baby rotations, two plaintext groups,
    one giant rotation."""
    with stats.recording():
        workloads.matvec_bsgs(cts[0].data, matvec)
        workloads.matvec_bsgs(cts[1].data, matvec)
    spans = stats.spans()
    tops = [s for s in spans if s.parent is None]
    assert [(s.name, s.request) for s in tops] == [("matvec_bsgs", 0),
                                                   ("matvec_bsgs", 1)]
    one = [(n, p) for n, p, r in _tree(spans) if r == 0]
    baby = [(p, "hrotate_hoisted_graph")
            for p in ["automorph", "inner_product", "moddown", "automorph",
                      "rotation_add"]]
    assert one == ([("matvec_bsgs", None),
                    ("hrotate_hoisted_graph", "matvec_bsgs"),
                    ("modup", "hrotate_hoisted_graph")] + 3 * baby
                   + [("pt_products", "matvec_bsgs")] * 2
                   + [("hrotate_graph", "matvec_bsgs"),
                      ("automorph", "hrotate_graph")]
                   + [(p, "hrotate_graph") for p in KEYSWITCH]
                   + [("rotation_add", "hrotate_graph")])
    assert len(spans) == 2 * len(one)
    assert all(s.request == 1 for s in spans[len(one):])


def test_logreg_span_tree(eng, cts):
    """The slot sum's 7 rotations, then hsquare and hmult, under one
    logreg_sigmoid3 span."""
    prep = workloads.logreg_prep(eng, np.ones(128) / 128, 0.1, LEVEL, SCALE)
    with stats.recording():
        workloads.logreg_sigmoid3(cts[0].data, prep)
    spans = stats.spans()
    assert spans[0].name == "logreg_sigmoid3" and spans[0].parent is None
    children = [s.name for s in spans if s.parent == 0]
    assert children == 7 * ["hrotate_graph"] + ["hsquare_graph",
                                                "hmult_graph"]
    assert {s.request for s in spans} == {0}
    assert len(spans) == 1 + 7 * 6 + 2 * 5


def test_graph_route_records_nothing(eng, cts):
    geng = CkksEngine(eng.params, 7, device="cpu", ntt_mode="jnp")
    geng.keygen()
    with stats.recording():
        geng.hmult(cts[0], cts[1])
        geng.hrotate(cts[0], 1)
    assert stats.spans() == []


def test_off_records_nothing_and_makes_no_event(eng, cts, monkeypatch):
    made = []

    class Event:
        def __init__(self, **kw):
            made.append(kw)

        def record(self):
            pass

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    stats.SPANS.clear()
    assert stats.span("x") is stats.NO_SPAN
    eng.hmult(cts[0], cts[1])
    eng.hrotate(cts[0], 1)
    assert stats.spans() == [] and made == []
    assert kernels.SPANS is None


def test_launches_credit_the_innermost_span():
    kernels.reset_launch_counts()
    with stats.recording():
        with stats.span("outer"):
            kernels.count("ntt_fwd")
            with stats.span("inner"):
                kernels.count("bconv")
                kernels.count("bconv")
                assert kernels.SPANS is stats.SPANS
            kernels.count("hpip")
        kernels.count("ntt_inv")  # no span open: credited to none
        assert kernels.SPANS is None
    outer, inner = stats.spans()
    assert dict(outer.launches) == {"ntt_fwd": 1, "hpip": 1}
    assert dict(inner.launches) == {"bconv": 2}
    # B1 and B4 run two device kernels a launch
    assert outer.device_kernels == 4 and inner.device_kernels == 2
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "ntt_fwd": 1, "bconv": 2, "hpip": 1, "ntt_inv": 1}
    kernels.reset_launch_counts()


def test_one_stack_a_thread():
    """Two threads open nested spans in lockstep: each span's parent is
    its own thread's, each thread's top span its own request."""
    steps = threading.Barrier(2)
    launched = {}

    def worker(tag):
        with stats.span(f"op_{tag}"):
            steps.wait()
            with stats.span(f"phase_{tag}"):
                steps.wait()
                kernels.count("bconv")
                steps.wait()
            steps.wait()
        launched[tag] = True

    with stats.recording():
        ts = [threading.Thread(target=worker, args=(t,)) for t in "ab"]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    kernels.reset_launch_counts()
    spans = stats.spans()
    assert sorted(launched) == ["a", "b"] and len(spans) == 4
    by = {s.name: s for s in spans}
    for t in "ab":
        op, phase = by[f"op_{t}"], by[f"phase_{t}"]
        assert op.parent is None and phase.parent == op.index
        assert phase.request == op.request
        assert dict(phase.launches) == {"bconv": 1} and not op.launches
    assert {by["op_a"].request, by["op_b"].request} == {0, 1}


def test_thread_mesh_shards_record_nothing(eng, cts):
    """The coefficient-sharded hmult on a ThreadMesh of 4: the shard
    programs (a sharded basis) record no span; the same bits as with
    recording off."""
    from homulator_tpu_torch.parallel.comm import ThreadMesh
    from homulator_tpu_torch.parallel.sharded import (
        gather_cols, make_shardmap_hmult, shard_cols,
    )

    ns = 4
    f = make_shardmap_hmult(eng.dc, LEVEL, ThreadMesh(ns, "cpu", timeout=60))
    args = (shard_cols(cts[0].data, ns), shard_cols(cts[1].data, ns),
            shard_cols(eng.relin_key, ns))
    off = gather_cols(f(*args))
    with stats.recording():
        on = gather_cols(f(*args))
    assert torch.equal(off, on)
    assert stats.spans() == []


def test_same_bits_recording_on_and_off(eng, cts, matvec):
    def run():
        return [eng.hmult(cts[0], cts[1]).data, eng.hrotate(cts[2], 1).data,
                _hmult_batch(eng, cts),
                workloads.matvec_bsgs(cts[3].data, matvec)]

    off = run()
    with stats.recording():
        on = run()
    assert len(stats.spans()) > 0
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_profiler_session_starts_a_new_record(eng, cts):
    from torch.profiler import ProfilerActivity, profile

    with stats.recording():
        eng.hrotate(cts[0], 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.hmult(cts[0], cts[1])
    assert [s.name for s in stats.spans() if s.parent is None] == \
        ["hmult_graph"]
    # the spans are record_function ranges of the profile too
    names = {e.name for e in prof.events()}
    assert {"hmult_graph", "tensor", "modup", "inner_product",
            "moddown"} <= names
    eng.hadd(cts[0], cts[1])  # no span
    eng.hmult(cts[0], cts[1])  # recording off: marks the record stale
    assert len(stats.spans()) == 5  # kept until the next record begins
    with profile(activities=[ProfilerActivity.CPU]):
        eng.hsquare(cts[0])
    assert [s.name for s in stats.spans() if s.parent is None] == \
        ["hsquare_graph"]


class _ClockEvent:
    """A stand-in CUDA event: record() takes the next tick of a clock."""

    clock = iter(())
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None

    def record(self):
        self.t = next(self.clock)

    def elapsed_time(self, end):
        return float(end.t - self.t)


@pytest.fixture
def clock_events(monkeypatch):
    synced = []
    monkeypatch.setattr(_ClockEvent, "clock", iter(range(100000)))
    monkeypatch.setattr(_ClockEvent, "made", 0)
    monkeypatch.setattr(torch.cuda, "Event", _ClockEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: synced.append(1))
    return synced


def test_device_times_from_the_event_pair(eng, cts, clock_events):
    """Where CUDA is in use each span records two events on the current
    stream; spans() synchronises and reads when each passed, after the
    record's first event."""
    with stats.recording():
        eng.hmult(cts[0], cts[1])
    spans = stats.spans()
    assert clock_events == [1]
    # events in order: op start, then each phase's pair, then op end
    assert [s.device_start_ms for s in spans] == [0.0, 1.0, 3.0, 5.0, 7.0]
    assert [s.device_ms for s in spans] == [9.0, 1.0, 1.0, 1.0, 1.0]
    assert all(s.events is None for s in spans)
    rows = {r["span"]: r for r in stats.span_table(spans)}
    assert rows["hmult_graph"]["device_self_ms"] == 5.0
    assert rows["modup"]["calls"] == 1 and rows["modup"]["launches"] == 0


def test_workload_spans_take_no_events(eng, cts, matvec, clock_events):
    """A workload's span and every span under it are untimed: no event is
    made, no device time read; an op called directly takes its pairs."""
    with stats.recording():
        workloads.matvec_bsgs(cts[0].data, matvec)
    spans = stats.spans()
    assert len(spans) > 20 and _ClockEvent.made == 0
    assert all(not s.timed and s.device_ms is None for s in spans)
    assert clock_events == []
    with stats.recording():
        eng.hrotate(cts[0], 1)
    spans = stats.spans()
    assert all(s.timed for s in spans)
    assert _ClockEvent.made == 2 * len(spans) == 12


def test_profiled_ms_leaves_out_the_spans_annotations(monkeypatch):
    """benchlib.profiled_ms adds the device's kernels, not the user
    annotations the profiler mirrors a span's range as."""
    import types

    from homulator_tpu_torch import benchlib

    cuda = torch.autograd.DeviceType.CUDA

    def ev(name, us, annotation=False):
        return types.SimpleNamespace(
            name=name, device_type=cuda, is_user_annotation=annotation,
            time_range=types.SimpleNamespace(elapsed_us=lambda: us))

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [ev("ntt_fwd_radix_a", 30.0), ev("hmult_graph", 90.0, True),
                    ev("elementwise_kernel", 50.0), ev("modup", 20.0, True)]

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    ms, groups, _ = benchlib.profiled_ms(lambda: None, calls=2)
    assert ms == pytest.approx(80.0 / 2 / 1e3)
    assert groups == {"all": pytest.approx(0.04)}


def test_cli_profile_prints_the_span_table(capsys, tmp_path):
    rc = cli.main(["run", "configs/tiny.cfg", "hmult", "8", "4", "4",
                   "--iters", "2", "--device", "cpu", "--profile",
                   str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "# spans over 2 run(s)" in out
    rows = {line.split()[0]: line.split() for line in out.splitlines()
            if line.split() and line.split()[0] in
            ("hmult_graph", "tensor", "modup", "inner_product", "moddown")}
    assert sorted(rows) == sorted(["hmult_graph", "tensor", "modup",
                                   "inner_product", "moddown"])
    for cols in rows.values():
        assert cols[1] == "2" and cols[3] == "-"  # two calls; no device time
        assert float(cols[2]) >= 0.0
