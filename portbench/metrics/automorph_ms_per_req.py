"""automorph_ms_per_req (ms), a workload step: device busy time inside the
port's `automorph` spans (api.py: the slot permutation of both components,
ops/automorph.py's gathers, before a rotation's key switch), summed over
the traced burst, over its requests (metrics/_spans.py). Read where the
rotations are timed, under HELR's iteration. None without the port's spans
or device times (the CPU, the control). Moves requests_per_s."""

from portbench.metrics._spans import device_ms_per_req


def read(rec):
    return device_ms_per_req(rec, ("automorph",))
