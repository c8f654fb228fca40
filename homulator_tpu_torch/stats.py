"""Metrics registry: the real-profiler counterpart of the reference's
Statistic table (include/Staistics.h:6-41 [sic]).

The port's own copy of `Statistic` and `op_modmul_count` from
`homulator_tpu/stats.py`, unchanged (the XLA cost counters stay behind:
they read compiled XLA executables).

The reference counts per-unit busy cycles, memory stalls, HBM beats, SPM
words, and NoC transfers, then dumps a sorted table at end of run. Here the
same surface reports wall-clock kernel timings, op counts, and modeled
data-movement volumes; `show()` prints the sorted table (Staistics.h:30-36
parity) and `to_json()` emits machine-readable output.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class Statistic:
    def __init__(self) -> None:
        self.counters: Dict[str, float] = defaultdict(float)
        self.timings: Dict[str, list] = defaultdict(list)

    def increase(self, key: str, amount: float = 1.0) -> None:
        self.counters[key] += amount

    def set(self, key: str, value: float) -> None:
        self.counters[key] = value

    @contextmanager
    def timer(self, key: str):
        t0 = time.perf_counter()
        yield
        self.timings[key].append(time.perf_counter() - t0)

    def record_time(self, key: str, seconds: float) -> None:
        self.timings[key].append(seconds)

    # ---- reporting -------------------------------------------------------
    def table(self) -> str:
        lines = ["%-40s %16s" % ("stat", "value")]
        for k in sorted(self.counters):
            lines.append("%-40s %16.0f" % (k, self.counters[k]))
        for k in sorted(self.timings):
            ts = self.timings[k]
            lines.append(
                "%-40s %13.3f ms (n=%d, min %.3f)"
                % (k + "_ms", 1e3 * sum(ts) / len(ts), len(ts), 1e3 * min(ts))
            )
        return "\n".join(lines)

    def show(self) -> None:
        print(self.table())

    def to_json(self) -> str:
        out = dict(self.counters)
        for k, ts in self.timings.items():
            out[k + "_ms_mean"] = 1e3 * sum(ts) / len(ts)
            out[k + "_ms_min"] = 1e3 * min(ts)
            out[k + "_count"] = len(ts)
        return json.dumps(out)


def op_modmul_count(op: str, n: int, level: int, alpha: int, dnum_used: int) -> int:
    """Analytic modmul counts per op (for roofline accounting).

    NTT/iNTT of one limb: ~(log2(n)/2 + 1) * n constant multiplies.
    """
    logn = n.bit_length() - 1
    ntt_cost = (logn // 2 + logn - logn // 2) * (n // 2) + n  # butterflies + mid
    l, a = level, alpha
    if op in ("hadd", "hsub", "padd"):
        return 0
    if op == "pmult":
        return 2 * l * n
    if op in ("hmult", "hsquare", "hrotate"):
        beta = -(-l // a)
        ks_ntt = l + beta * (l + a) + 2 * (a + l)  # modup intt+ntt, moddown per k
        ks_bconv = beta * (l + a) * min(a, l) + 2 * l * a
        ks_ip = 2 * beta * (l + a)
        total = ks_ntt * ntt_cost + (ks_bconv + ks_ip) * n
        if op in ("hmult", "hsquare"):
            # tensor + relin add (hsquare saves one tensor multiply)
            total += (5 if op == "hmult" else 4) * l * n
            total += 2 * ((l - 1) * n + 2 * ntt_cost)  # rescale both components
        return total
    raise ValueError(op)
