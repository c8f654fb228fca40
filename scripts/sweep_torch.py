#!/usr/bin/env python3
"""Benchmark sweep of the port on the card: parameter sets A-D and M x
ops x levels.

    python3 scripts/sweep_torch.py [--sets A B C D M] [--ops hmult hadd ...]
                                   [--levels 35 20 10 2 | auto | all]
                                   [--iters 5] [--out outLogs] [--fused-hpip]

The counterpart of scripts/sweep.py (the reference's per-set shell
sweeps, script/para{A,B,C,D}/*.sh and script/motivation): the same
PARAM_SETS and OPS, every op at each chosen level of each set, one JSON
line a run appended to <out>/<set>/<op>_torch.jsonl, beside the JAX
package's <op>.jsonl and never over it. `--levels auto` takes the JAX
script's subset {max, 3/4, 1/2, 1/4, 2} (and 35 at set B), `all` every
level from max down to 2; with `all` or more than 8 levels the sweep runs
level-major and drops the context's per-level caches (NTT bases,
key-switch and rescale tables, the primes of a level) after each level,
as the JAX script does for its device memory.

Each line carries the JAX record's keys (set, op, n, max_level, level,
alpha, latency_ms, setup_s, backend) and beside them eager_ms, route and
the card's name and power limit. latency_ms is the op's device time, the
counterpart of the JAX script's chained device loop: `--iters` calls of
the op captured in a CUDA graph, the graph replayed between CUDA events
(benchlib.device_ms); eager_ms is what a caller waits for, the median of
`--iters` eager calls between CUDA events after three warm-ups
(benchlib.latency_ms). setup_s is the host seconds of the line's
encryptions, encode and timing. hmult and hrotate(1) take the piecewise
key-switch route, or with --fused-hpip the fused HPIP route
(api.USE_FUSED_HPIP); hadd, pmult and padd switch no key, and `route`
names the engine's route all the same. Every key comes from the native
host core (built at first use). Needs the card; imports no JAX and
nothing of the JAX package.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

# The reference's parameter sets (script/README.md:17-22), as
# scripts/sweep.py defines them; "M" is script/motivation's set-A limb
# structure on the N = 2^16 ring.
PARAM_SETS = {
    "A": dict(n=2**15, max_level=28, alpha=28),
    "B": dict(n=2**16, max_level=45, alpha=15),
    "C": dict(n=2**16, max_level=24, alpha=6),
    "D": dict(n=2**16, max_level=26, alpha=9),
    "M": dict(n=2**16, max_level=28, alpha=28),
}
OPS = ["hmult", "hadd", "hrotate", "pmult", "padd"]
SCALE = 2.0**29


def levels_for(set_name: str, levels_arg):
    """The levels a sweep of set_name runs, highest first: "all", "auto"
    (scripts/sweep.py's subset) or an explicit list, cut to [2, max]."""
    L = PARAM_SETS[set_name]["max_level"]
    if levels_arg == "all":
        return list(range(L, 1, -1))
    if levels_arg == "auto":
        levels = {L, 3 * L // 4, L // 2, L // 4, 2}
        if set_name == "B":
            levels.add(35)  # the canonical point
        return sorted(levels, reverse=True)
    return [lv for lv in levels_arg if 2 <= lv <= L]


def record(set_name: str, op: str, level: int, latency_ms: float,
           setup_s: float, eager_ms: float, route: str, card: str,
           backend: str = "cuda") -> dict:
    """One line of <op>_torch.jsonl: the JAX sweep's keys, then the
    port's."""
    cfg = PARAM_SETS[set_name]
    return {"set": set_name, "op": op, "n": cfg["n"],
            "max_level": cfg["max_level"], "level": level,
            "alpha": cfg["alpha"], "latency_ms": latency_ms,
            "setup_s": setup_s, "backend": backend, "eager_ms": eager_ms,
            "route": route, "card": card}


def clear_level_caches(dc) -> None:
    """Drop a DeviceContext's per-level tables (the NTT bases, key-switch
    and rescale tables and the primes of each level); the automorphism
    tables, which do not depend on the level, stay."""
    for cache in (dc._nt_cache, dc._ks_cache, dc._rs_cache, dc._q_cache):
        cache.clear()


def op_fn(eng, op: str, ct1, ct2, pt):
    """The call the sweep times for `op` (hrotate by one slot)."""
    return {"hmult": lambda: eng.hmult(ct1, ct2),
            "hrotate": lambda: eng.hrotate(ct1, 1),
            "hadd": lambda: eng.hadd(ct1, ct2),
            "pmult": lambda: eng.pmult(ct1, pt),
            "padd": lambda: eng.padd(ct1, pt)}[op]


def run_sweep(sets, ops, levels_arg, iters, out_dir, fused):
    import torch

    from homulator_tpu_torch import api, benchlib, kernels
    from homulator_tpu_torch.params import get_params
    from homulator_tpu_torch.workloads import native_engine

    if not torch.cuda.is_available():
        raise SystemExit("sweep_torch: needs a CUDA card")
    api.USE_FUSED_HPIP = fused
    route = "fused" if fused else "piecewise"
    card = benchlib.card_line()
    kernels.build()
    print(f"# {card}; route {route}", flush=True)
    for set_name in sets:
        t0 = time.perf_counter()
        params = get_params(**PARAM_SETS[set_name])
        eng = native_engine(params, seed=1)
        eng.keygen()
        if "hrotate" in ops:
            eng.gen_rotation_key(1)
        print(f"# set {set_name}: params and keys {time.perf_counter() - t0:.1f}"
              " s (host, native core)", flush=True)
        levels = levels_for(set_name, levels_arg)
        os.makedirs(os.path.join(out_dir, set_name), exist_ok=True)

        def measure(op, level):
            t0 = time.perf_counter()
            m = np.zeros(params.n, dtype=np.int64)
            m[0] = int(3 * SCALE)
            ct1 = eng.encrypt_ints(m, level, SCALE)
            ct2 = eng.encrypt_ints(m, level, SCALE)
            pt = eng.plaintext_ints(m, level, 1.0)
            fn = op_fn(eng, op, ct1, ct2, pt)
            dev = benchlib.device_ms(fn, calls=iters)
            eager = benchlib.latency_ms(fn, iters=iters)
            rec = record(set_name, op, level, dev,
                         time.perf_counter() - t0, eager, route, card)
            path = os.path.join(out_dir, set_name, f"{op}_torch.jsonl")
            with open(path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)

        if levels_arg == "all" or len(levels) > 8:
            for level in levels:  # level-major, caches dropped a level
                for op in ops:
                    measure(op, level)
                clear_level_caches(eng.dc)
                torch.cuda.empty_cache()
        else:
            for op in ops:
                for level in levels:
                    measure(op, level)
        del eng
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sets", nargs="+", default=["B"],
                    choices=list(PARAM_SETS))
    ap.add_argument("--ops", nargs="+", default=OPS, choices=OPS)
    ap.add_argument("--levels", nargs="+", default=["35", "20", "10", "2"])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(ROOT, "outLogs"))
    ap.add_argument("--fused-hpip", action="store_true",
                    help="the fused HPIP key-switch route")
    args = ap.parse_args()
    if args.levels in (["all"], ["auto"]):
        levels = args.levels[0]
    else:
        levels = [int(x) for x in args.levels]
    run_sweep(args.sets, args.ops, levels, args.iters, args.out,
              args.fused_hpip)


if __name__ == "__main__":
    main()
