"""requests_per_s (req/s): requests completed in the window over the
window's whole length on the host clock (start of the first request to
the end of the last), one client in a closed loop. As
requests_per_s.host_paced the same rate in host-paced cells, under its own
bound."""

from portbench.harness.loop import rate


def read(rec):
    return rate(rec.window.requests, rec.window.window_s)
