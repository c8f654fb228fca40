"""device_idle_pct (%), the device: the share of the measured window in
which the device is idle, 1 - requests_per_s x device busy seconds a
request. The rate is the run's untraced window's; the busy time a request
is the union of device operations in its traced burst (kernel times do not
change under the profiler; the host's enqueue does, so the traced window's
own idle share, the result line's 1 - busy_s / window_s, reads higher in a
host-paced cell). Moves requests_per_s, and as device_idle_pct.host_paced
requests_per_s.host_paced."""

from portbench.harness.loop import rate


def read(rec):
    p = rec.profile
    if not p or p.busy_s <= 0:
        return None
    r = rate(rec.window.requests, rec.window.window_s)
    return 100.0 * (1.0 - r * p.busy_s / p.requests)
