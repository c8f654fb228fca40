"""request_ms_p95 (ms): the 95th percentile over every request of the
window, each from the call to the end of its device work (CUDA events on
the stream, harness/loop.py)."""

from portbench.harness.loop import p95


def read(rec):
    return p95(rec.window.latency_ms)
