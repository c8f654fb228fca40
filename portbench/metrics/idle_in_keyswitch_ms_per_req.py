"""idle_in_keyswitch_ms_per_req (ms), the key-switch phases starving the
device: device idle time in the traced burst whose gap's middle falls, on
the burst's clock (metrics/_spans.py), inside a `modup`, `inner_product` or
`moddown` span as the innermost port span, over the requests. Read as
idle_in_keyswitch_ms_per_req.host_paced in the matvec cell, where it moves
requests_per_s.host_paced. Under the profiler the spans' own cost (their
record_function ranges and bookkeeping) is part of what it reads; PERF.md
gives the parent's traced reading, without spans, beside it."""

from portbench.metrics._spans import idle_ms_per_req


def read(rec):
    return idle_ms_per_req(rec, keyswitch=True)
