#!/usr/bin/env python3
"""Batched-hmult throughput of the port on one card (the serving shape).

    python3 scripts/bench_batched_torch.py [--set B|C] [--out BATCHED_H100.json]

The counterpart of scripts/bench_batched.py: hmult at parameter set B
(N = 2^16, maxLevel 45, level 35, alpha 15; or --set C: maxLevel 24,
level 24, alpha 6, four digits) over batches of B = 1, 2, 4
and 8 ciphertexts as one program (parallel.sharded.batched_hmult_fn: one
call of the op graph on [B, 2, level, 256, 256], every kernel launch
covering the batch, the key and the tables read once), on the piecewise
and the fused HPIP key-switch route. Before any timing each batch is
checked bit for bit against B single engine.hmult calls, and its launches
of B1-B4 and B18 against one element's. At each B: the device time of one batch
(CUDA-graph replay, benchlib.device_ms) and its eager latency (CUDA events
around one call, median of 20 after 3 warm-ups, benchlib.latency_ms),
each per op (over B) and as ops/s, and the speedup at B = 8 against B = 1.
One JSON object (with the card's name and power limit) is printed and
written to --out. Needs the card; imports no JAX and nothing of the JAX
package.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

N = 65536
SETS = {"B": (45, 35, 15), "C": (24, 24, 6)}  # maxLevel, level, alpha
BATCHES = (1, 2, 4, 8)
SCALE = 2.0**29
KERNELS = ("ntt_fwd", "ntt_inv", "bconv", "hpip", "ip")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", choices=sorted(SETS), default="B")
    ap.add_argument("--out", default=os.path.join(ROOT, "BATCHED_H100.json"))
    args = ap.parse_args()
    max_level, level, alpha = SETS[args.set]

    import torch

    from homulator_tpu_torch import api, benchlib, kernels
    from homulator_tpu_torch.params import get_params
    from homulator_tpu_torch.parallel.sharded import batched_hmult_fn
    from homulator_tpu_torch.workloads import native_engine

    if not torch.cuda.is_available():
        raise SystemExit("bench_batched_torch: needs a CUDA card")
    kernels.build()
    t0 = time.perf_counter()
    eng = native_engine(get_params(n=N, max_level=max_level, alpha=alpha),
                        seed=1)
    eng.keygen()
    rng = np.random.default_rng(0)
    cts = [eng.encrypt_complex(rng.normal(size=eng.params.n // 2), level,
                               SCALE)
           for _ in range(2 * max(BATCHES))]
    setup_s = time.perf_counter() - t0
    f = batched_hmult_fn(eng.dc, level)
    key = eng.relin_key
    out = {"backend": "cuda", "op": "hmult",
           "shape": f"L={max_level} l={level} alpha={alpha}",
           "card": benchlib.card_line(),
           "host_setup_s": setup_s}
    for route in ("piecewise", "fused"):
        api.USE_FUSED_HPIP = route == "fused"
        try:
            singles = [eng.hmult(cts[2 * i], cts[2 * i + 1]).data
                       for i in range(max(BATCHES))]
            res = {}
            for B in BATCHES:
                t0 = time.perf_counter()
                a = torch.stack([c.data for c in cts[0:2 * B:2]])
                b = torch.stack([c.data for c in cts[1:2 * B:2]])
                kernels.reset_launch_counts()
                got = f(a, b, key)
                torch.cuda.synchronize()
                launches = {k: kernels.LAUNCHES[k] for k in KERNELS}
                if not torch.equal(got, torch.stack(singles[:B])):
                    raise AssertionError(f"{route} batch {B} != {B} single "
                                         "hmults")
                dev = benchlib.device_ms(lambda: f(a, b, key), calls=2)
                eager = benchlib.latency_ms(lambda: f(a, b, key))
                res[B] = {"device_ms": dev, "eager_ms": eager,
                          "per_op_ms": dev / B, "eager_per_op_ms": eager / B,
                          "ops_per_s": 1e3 * B / dev,
                          "eager_ops_per_s": 1e3 * B / eager,
                          "launches": launches,
                          "setup_s": time.perf_counter() - t0}
                print(f"# {route} B={B}: {json.dumps(res[B])}", flush=True)
            if any(res[B]["launches"] != res[1]["launches"] for B in res):
                raise AssertionError(f"{route}: a batch launched B1-B4, B18 "
                                     "otherwise than one element")
        finally:
            api.USE_FUSED_HPIP = False
        for B, r in res.items():
            for k in ("per_op_ms", "eager_per_op_ms", "ops_per_s",
                      "eager_ops_per_s", "setup_s"):
                out[f"{route}_batch{B}_{k}"] = r[k]
            out[f"{route}_batch{B}_launches"] = r["launches"]
        out[f"{route}_batch8_speedup_vs_b1"] = (res[1]["per_op_ms"]
                                                / res[8]["per_op_ms"])
        out[f"{route}_batch8_eager_speedup_vs_b1"] = (
            res[1]["eager_per_op_ms"] / res[8]["eager_per_op_ms"])
    print(json.dumps(out))
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
