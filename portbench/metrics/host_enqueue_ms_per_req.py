"""host_enqueue_ms_per_req (ms), the engine and op graph on the host: the
benchmark's span from the call to its return, before the synchronise,
averaged over every request of the window. Moves requests_per_s (as
host_enqueue_ms_per_req.host_paced, requests_per_s.host_paced): in the
closed loop a request's latency is the later of its enqueue and its device
work, and the rate is one over their mean."""


def read(rec):
    e = rec.window.enqueue_s
    return 1e3 * sum(e) / len(e) if e else None
