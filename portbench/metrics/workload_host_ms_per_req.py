"""workload_host_ms_per_req (ms), the workload steps on the host: host self
time of every port span other than the key-switch phases (the op and
workload spans themselves, `automorph`, `pt_products`, `rotation_add`) in
the traced burst, over its requests. With keyswitch_host_ms_per_req it
makes the requests' whole host time in the port. Read as
workload_host_ms_per_req.host_paced in the matvec cell, where it moves
requests_per_s.host_paced. Under the profiler the spans' own cost (their
record_function ranges and bookkeeping) is part of what it reads; PERF.md
gives the parent's traced reading, without spans, beside it."""

from portbench.metrics._spans import host_self_ms_per_req


def read(rec):
    return host_self_ms_per_req(rec, keyswitch=False)
