"""launches_per_req (launches), the op graph: device operations (kernels,
copies, sets) in the traced burst over its requests. Each costs the host
an enqueue and the device a launch. Moves requests_per_s, and as
launches_per_req.host_paced requests_per_s.host_paced."""


def read(rec):
    p = rec.profile
    return len(p.ops) / p.requests if p else None
