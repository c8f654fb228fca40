"""glue_ms_per_req (ms), the elementwise glue: device time of PyTorch's own
kernels, copies and sets (`harness.trace.is_glue`) in the traced burst
over its requests. Moves requests_per_s, and as glue_ms_per_req.host_paced
requests_per_s.host_paced."""

from portbench.harness.trace import is_glue


def read(rec):
    p = rec.profile
    if not p:
        return None
    return 1e3 * sum(b - a for n, a, b in p.ops if is_glue(n)) / p.requests
