"""tensor_ms_per_req (ms), the phase before hmult's key switch: device busy
time inside the port's `tensor` spans, the tensor product (the d0, d1, d2
lines of api.hmult_graph): the union of the traced burst's device
operations between each span's two CUDA events on the burst's clock
(metrics/_spans.py), summed over the burst, over its requests; the device's
waits for the host inside a span are left out, but in a request where the
trace's clock stepped (metrics/_spans.py). The port times the spans of an
op called directly, not those inside a workload, so it is read in the hmult
cells. None without the port's spans or device times (the CPU, the control,
the matvec). Moves requests_per_s."""

from portbench.metrics._spans import device_ms_per_req


def read(rec):
    return device_ms_per_req(rec, ("tensor",))
