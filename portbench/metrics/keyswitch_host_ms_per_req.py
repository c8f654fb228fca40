"""keyswitch_host_ms_per_req (ms), the key-switch phases on the host: host
self time (a span's own time less its children's) of the port's `modup`,
`inner_product` and `moddown` spans in the traced burst, over its requests.
Read as keyswitch_host_ms_per_req.host_paced in the host-paced matvec cell,
where it moves requests_per_s.host_paced. Under the profiler the spans' own
cost (their record_function ranges and bookkeeping) is part of what it
reads; PERF.md gives the parent's traced reading, without spans, beside it."""

from portbench.metrics._spans import host_self_ms_per_req


def read(rec):
    return host_self_ms_per_req(rec, keyswitch=True)
