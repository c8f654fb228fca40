"""request_roofline (%), all device work of a request: its least time
(counts/work.py at the cell's shapes over counts/peaks.py) over its device
busy time (the union of device operations in the traced burst, over its
requests). Moves requests_per_s, and as request_roofline.host_paced
requests_per_s.host_paced."""


def read(rec):
    p = rec.profile
    if not p or p.busy_s <= 0:
        return None
    return 100.0 * rec.work.least_s() / (p.busy_s / p.requests)
