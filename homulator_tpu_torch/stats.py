"""Metrics registry: the real-profiler counterpart of the reference's
Statistic table (include/Staistics.h:6-41 [sic]).

The port's own copy of `Statistic` and `op_modmul_count` from
`homulator_tpu/stats.py`, unchanged, and `torch_counters`, the
counterpart of its `xla_counters`: XLA reads HBM bytes, buffer sizes and
flops off a compiled executable; the port runs eagerly, so it counts one
run of the op instead (`OpCosts`, below). It reports no FLOPs_compiled:
no compiler counts the op's operations, and `op_modmul_count` already
gives its modular multiplies.

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
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from . import kernels


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


_aten = torch.ops.aten
# calls that move no bytes: allocations (views are func.is_view)
_ALLOCATIONS = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                _aten.new_empty, _aten.new_empty_strided, _aten.lift_fresh}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    s = t.untyped_storage()
    return (t.device, s.data_ptr()), s.nbytes()


class OpCosts(TorchDispatchMode):
    """The bytes one run of an op moves, counted, not measured.

    While `counting()`, every aten call adds the bytes of each tensor it
    reads and writes (operands plus outputs, op by op, as XLA's "bytes
    accessed"; views and allocations move none), and every kernel launch
    the bytes its wrapper declares (kernels.count). A kernel's plain
    version runs unobserved and adds its kernel's declaration instead
    (kernels.as_kernel), so an op counts the same bytes on the CPU and on
    the card. `arg_bytes` sums the storages read that the run did not make:
    the op's arguments and the tables it reads."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0
        self.paused = 0  # kernels.unobserved's depth
        self._made = set()
        self._args: Dict[tuple, int] = {}

    def _read(self, t: torch.Tensor) -> None:
        key, size = _storage(t)
        if key not in self._made:
            self._args[key] = size

    @property
    def arg_bytes(self) -> int:
        return sum(self._args.values())

    def kernel(self, reads, nbytes: int) -> None:
        """One kernel launch's declared traffic (kernels.declare)."""
        self.hbm_bytes += sum(_nbytes(t) for t in reads) + nbytes
        for t in reads:
            self._read(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if func.is_view:
            return out
        in_keys = {_storage(t)[0] for t in ins}
        if not self.paused and func.overloadpacket not in _ALLOCATIONS:
            self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
            for t in ins:
                self._read(t)
        self._made.update(k for k in (_storage(t)[0] for t in outs)
                          if k not in in_keys)
        return out

    @contextmanager
    def counting(self):
        """Count the block's aten calls and kernel launches."""
        if kernels.COSTS is not None:
            raise RuntimeError("an OpCosts count is already running")
        kernels.COSTS = self
        try:
            with self:
                yield self
        finally:
            kernels.COSTS = None


def torch_counters(run: Callable[[], torch.Tensor],
                   device: torch.device) -> Dict[str, float]:
    """Counters of one call of `run` (an op on `device`, returning its
    output tensor), named after the reference's Statistic surface as
    `xla_counters` names them:

      HBM_bytes      bytes the op's aten calls and kernels read and write,
                     counted (OpCosts), the same on the CPU and the card
      MEM_arg_bytes  the op's tensor arguments and the tables it reads
      MEM_out_bytes  its output
      MEM_temp_bytes on the card only: the caching allocator's peak
                     during the call above what was allocated when it
                     began (the arguments and tables among it), less the
                     output; absent on the CPU, which has no such
                     allocator statistics

    `run` is called twice: once to build what it builds on first use
    (tables, keys, the kernel library), then once counted."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    run()
    costs = OpCosts()
    if cuda:
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    with costs.counting():
        out = run()
    out_bytes = _nbytes(out)
    res = {"HBM_bytes": float(costs.hbm_bytes),
           "MEM_arg_bytes": float(costs.arg_bytes),
           "MEM_out_bytes": float(out_bytes)}
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        res["MEM_temp_bytes"] = float(peak - before - out_bytes)
    return res


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
