"""idle_in_workload_ms_per_req (ms), the workload steps starving the device:
device idle time in the traced burst whose gap's middle falls inside any
other port span as the innermost one (the op and workload spans,
`automorph`, `pt_products`, `rotation_add`), over the requests. Read as
idle_in_workload_ms_per_req.host_paced in the matvec cell, where it moves
requests_per_s.host_paced. Under the profiler the spans' own cost (their
record_function ranges and bookkeeping) is part of what it reads; PERF.md
gives the parent's traced reading, without spans, beside it."""

from portbench.metrics._spans import idle_ms_per_req


def read(rec):
    return idle_ms_per_req(rec, keyswitch=False)
