"""port_kernels_ms_per_req (ms), the port's kernels: device time of every
kernel that is not PyTorch's own (`harness.trace.is_glue`) in the traced
burst over its requests. Moves requests_per_s, and as
port_kernels_ms_per_req.host_paced requests_per_s.host_paced."""

from portbench.harness.trace import is_glue


def read(rec):
    p = rec.profile
    if not p:
        return None
    t = sum(b - a for n, a, b in p.ops if not is_glue(n))
    return 1e3 * t / p.requests if t > 0 else None
