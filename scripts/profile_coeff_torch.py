#!/usr/bin/env python3
"""Latency and device time of the sharded hmult and hrotate of the PyTorch
+ CUDA port, by dispatch and shard count, on one CUDA GPU.

    python3 scripts/profile_coeff_torch.py [--shards 1 2 4 8 16 32]
        [--dispatch coeff limb hybrid] [--no-baton]

Runs the coefficient-sharded `parallel.sharded.make_shardmap_hmult` and
`make_shardmap_hrotate` (step 1) at (45,35,15) of parameter set B (N =
2^16) on a `ThreadMesh` of each shard count on this one card, and the
single-device ops beside them; with `--dispatch limb` also the
limb-sharded ops (`parallel.limb_sharded.make_limb_*`, whole-limb B1/B2
per shard) and with `hybrid` the hybrid ones on [shards/2 limb x 2 coeff]
(`make_hybrid_*`, B6-B9), from 4 shards on.
At their default routing, as in the JAX package, a shard count where
`pack_k_for` > 0 (8, 16, 32) takes the lane-packed phase kernels B10-B13;
there each coefficient-sharded op also runs with packed=False (the
per-limb B6-B9), the A/B of whether packing pays on this card, and the
"phase kernels" column gives the device time of the phase kernels of the
run (B10-B13 or B6-B9).
The single-device hmult also runs in a new thread per call, as a
ThreadMesh starts its shard threads. For each: the eager latency (CUDA
events around a synchronised call, median of 20 after 3 warm-up calls;
for the sharded ops this is the shard threads on one card, not a
multi-card latency), the device kernel time per op from torch.profiler
over 5 calls grouped by kernel (benchlib.profiled_ms: the phase kernels
B6-B9, B1/B2, B3, torch copies and concatenations, torch elementwise),
the card's idle share of the eager call, 1 - device time / latency, the
host time (the call's wall time until it returns, without a synchronise;
median of 20) and the CUDA runtime calls per op that wait for the device
or copy through the host (synchronise, memcpy; from the profiler's
runtime events). `--no-baton` runs the shards without ThreadMesh's baton
lock, so their threads contend for the interpreter lock at every torch
call. Prints the card's name and power limit first. Imports no JAX and
nothing of the JAX package.
"""

import argparse
import os
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL = 35
CALLS = 5

GROUPS = (  # (group, substrings of the kernel name); the first match wins
    ("B10 ntt_phase1_packed", ("packed_phase1_radix",)),
    ("B11 ntt_phase2_packed", ("packed_phase2_radix",)),
    ("B12 intt_phase2_packed", ("packed_iphase2_radix",)),
    ("B13 intt_phase1_packed", ("packed_iphase1_radix",)),
    ("B1 ntt_fwd", ("ntt_fwd_radix",)),
    ("B2 ntt_inv", ("ntt_inv_radix",)),
    ("B6 ntt_phase1", ("ntt_phase1_radix",)),
    ("B8 intt_phase2", ("ntt_iphase2_radix",)),
    ("B7 ntt_phase2", ("ntt_phase2_radix",)),
    ("B9 intt_phase1", ("ntt_iphase1_radix",)),
    ("B3 bconv", ("bconv",)),
    ("B4 hpip", ("hpip",)),
    ("torch copies, concatenations and gathers",
     ("copy", "Cat", "Memcpy", "index", "gather")),
    ("torch reductions", ("reduce",)),
    ("torch elementwise", ("elementwise", "Memset")),
)


# the coefficient shards' phase kernels (per limb, lane-packed)
PHASE_GROUPS = ("B6", "B7", "B8", "B9", "B10", "B11", "B12", "B13")


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def host_ms(torch, fn, iters=20):
    """Median host time of fn until it returns, the device idle at the
    start of each call (time.perf_counter, no synchronise inside)."""
    import statistics
    import time

    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16, 32])
    ap.add_argument("--dispatch", nargs="+", default=["coeff"],
                    choices=["coeff", "limb", "hybrid"],
                    help="the sharded dispatches to run at each shard count "
                         "(hybrid: [shards/2 limb x 2 coeff], from 4 on)")
    ap.add_argument("--no-baton", action="store_true",
                    help="shard threads without ThreadMesh's baton lock")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_coeff_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from homulator_tpu_torch.api import CkksEngine, get_params
    from homulator_tpu_torch.benchlib import card_line, latency_ms, profiled_ms
    from homulator_tpu_torch.parallel import limb_sharded as ls
    from homulator_tpu_torch.parallel.comm import ThreadMesh
    from homulator_tpu_torch.parallel.mesh import pack_k_for
    from homulator_tpu_torch.parallel.sharded import (
        make_shardmap_hmult, make_shardmap_hrotate, shard_cols,
    )

    class NoBatonMesh(ThreadMesh):
        def _take_baton(self, comm):
            pass

        def _give_baton(self, comm):
            pass

    print(card_line())

    params = get_params(n=1 << 16, max_level=45, alpha=15)
    eng = CkksEngine(params, seed=1, device="cuda")
    eng.keygen()
    eng.gen_rotation_key(1)
    rng = np.random.default_rng(7)
    slots = params.n // 2
    scale = float(1 << 29)
    ct1 = eng.encrypt_complex(rng.normal(size=slots), LEVEL, scale)
    ct2 = eng.encrypt_complex(rng.normal(size=slots), LEVEL, scale)

    def in_new_thread():
        t = threading.Thread(target=lambda: eng.hmult(ct1, ct2))
        t.start()
        t.join()

    runs = {"single-device hmult": lambda: eng.hmult(ct1, ct2),
            "single-device hmult, new thread per call": in_new_thread,
            "single-device hrotate": lambda: eng.hrotate(ct1, 1)}
    mesh_cls = NoBatonMesh if args.no_baton else ThreadMesh
    perm = eng.dc.automorph_perm(params.galois_elt(1))
    for ns in args.shards:
        if ns > 1 and "limb" in args.dispatch:
            mesh = mesh_cls(ns, "cuda", names=("limb",))
            a, b = (ls.shard_rows(c.data, LEVEL, ns) for c in (ct1, ct2))
            key, rkey = (ls.limb_key(k, params, LEVEL, ns)
                         for k in (eng.relin_key, eng.rot_keys[1]))
            fh = ls.make_limb_hmult(eng.dc, LEVEL, mesh)
            fr = ls.make_limb_hrotate(eng.dc, LEVEL, mesh)
            runs[f"hmult limb x{ns}"] = (
                lambda fh=fh, a=a, b=b, key=key: fh(a, b, key))
            runs[f"hrotate limb x{ns}"] = (
                lambda fr=fr, a=a, rkey=rkey: fr(a, perm, rkey))
        if ns >= 4 and ns % 2 == 0 and "hybrid" in args.dispatch:
            nl = ns // 2
            mesh = mesh_cls((nl, 2), "cuda", names=("limb", "coeff"))
            a, b = (ls.shard_rows(c.data, LEVEL, nl, 2) for c in (ct1, ct2))
            key, rkey = (ls.limb_key(k, params, LEVEL, nl, 2)
                         for k in (eng.relin_key, eng.rot_keys[1]))
            route = eng.dc.automorph_shard_route(params.galois_elt(1), 2)
            fh = ls.make_hybrid_hmult(eng.dc, LEVEL, mesh)
            fr = ls.make_hybrid_hrotate(eng.dc, LEVEL, mesh)
            runs[f"hmult hybrid {nl}x2"] = (
                lambda fh=fh, a=a, b=b, key=key: fh(a, b, key))
            runs[f"hrotate hybrid {nl}x2"] = (
                lambda fr=fr, a=a, r=route, rkey=rkey: fr(a, r, rkey))
        if "coeff" not in args.dispatch:
            continue
        mesh = mesh_cls(ns, "cuda")
        a, b = shard_cols(ct1.data, ns), shard_cols(ct2.data, ns)
        key, rkey = (shard_cols(k, ns) for k in (eng.relin_key,
                                                 eng.rot_keys[1]))
        route = eng.dc.automorph_shard_route(params.galois_elt(1), ns)
        k = pack_k_for(params.ntt.n1, params.ntt.n2, ns)
        for packed in (True, False) if k else (True,):
            tag = (f", packed k={k}" if packed else ", packed=False") if k \
                else ""
            fh = make_shardmap_hmult(eng.dc, LEVEL, mesh, packed=packed)
            fr = make_shardmap_hrotate(eng.dc, LEVEL, mesh, packed=packed)
            runs[f"hmult {ns} shards{tag}"] = (
                lambda fh=fh, a=a, b=b, key=key: fh(a, b, key))
            runs[f"hrotate {ns} shards{tag}"] = (
                lambda fr=fr, a=a, route=route, rkey=rkey: fr(a, route,
                                                              rkey))

    baton = "without the baton" if args.no_baton else "with the baton"
    print(f"# (45,{LEVEL},15) on one card, shard threads {baton}; eager: "
          "median of 20 after 3 warm-ups; device: torch.profiler over "
          f"{CALLS} calls")
    print("| Op | eager ms | device ms | idle share | host ms | "
          "phase kernels ms | waiting runtime calls / op | "
          "device ms by group |")
    print("|---|---|---|---|---|---|---|---|")
    for label, fn in runs.items():
        lat = latency_ms(fn)
        host = host_ms(torch, fn)
        dev, groups, waits = profiled_ms(fn, CALLS, group_of)
        phase = sum(v for g, v in groups.items()
                    if g.split()[0] in PHASE_GROUPS)
        top = ", ".join(f"{g} {v:.3f}" for g, v in
                        sorted(groups.items(), key=lambda kv: -kv[1]))
        wait = ", ".join(f"{k} {v:g}" for k, v in sorted(waits.items()))
        print(f"| {label} | {lat:.3f} | {dev:.3f} | "
              f"{max(0.0, 1 - dev / lat):.2f} | {host:.3f} | {phase:.3f} | "
              f"{wait or 0} | {top} |")
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "homulator_tpu"))
    if bad:
        raise AssertionError(f"imported {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
