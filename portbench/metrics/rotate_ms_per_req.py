"""rotate_ms_per_req (ms), a workload step: device busy time inside the
port's `hrotate_graph` spans (api.py: the automorphism, the key switch of
c1 and the add into c0, on a whole batch at once where the caller passes
one), summed over the traced burst, over its requests (metrics/_spans.py).
The port times these spans under a timed top-level span, HELR's iteration
(workloads.helr_iteration), and not inside the untimed matvec or logreg.
None without the port's spans or device times (the CPU, the control, a
port whose spans are untimed there). Moves requests_per_s."""

from portbench.metrics._spans import device_ms_per_req


def read(rec):
    return device_ms_per_req(rec, ("hrotate_graph",))
