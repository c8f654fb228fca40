#!/usr/bin/env python3
"""The sharded dispatches' data axis at set B on one card, for one checkout
of the port: a batch of hmults on 2 data rows, one element a shard (B = 2)
and two (B = 4).

    python3 scripts/bench_data_axis_torch.py [--root DIR] [--out FILE]

Times the `homulator_tpu_torch` of DIR (default: this checkout; another
one, such as an earlier commit unpacked with `git archive`, builds its own
kernels under its own build/) at set B (N = 2^16, maxLevel 45, alpha 15),
level 35, on four meshes of shard threads on the card, each with a leading
data axis of 2 rows:

  coeff 2x4          make_shardmap_hmult(data_axis="data"), 4 coefficient
                     shards a row (B6-B9, B3)
  limb 2x4           make_limb_hmult(data_axis="data"), 4 limb shards a
                     row (B1-B3)
  hybrid 2x(2x2)     make_hybrid_hmult(data_axis="data"), 2 limb x 2
                     coeff shards a row (B3, B6-B9)
  gspmd (2,2,2)      make_sharded_hmult on make_mesh((2, 2, 2)), the same
                     hybrid program behind the GSPMD surface

Each run is checked bit for bit against B single-device hmults; its
kernel launches (kernels.LAUNCHES, reset just before), the collective
calls of each shard on each axis and the bytes each shard received are
recorded, and its eager latency (CUDA events, median of 20 after 3
warm-ups, benchlib.latency_ms) and device time (torch.profiler over 5
calls, benchlib.profiled_ms: no CUDA graph spans the shard threads) are
taken. It asserts nothing about the counts, so it runs on a checkout whose
shards loop over their elements; chip_smoke.py holds this checkout's
counts (B = 4 launches and calls equal to B = 2's, bytes twice) through
`data_cases` and `run_case`. Prints the card's name and power limit and
one JSON line, also written to FILE. To compare two commits, run both in
one call on one card, in turns: parent, change, change, parent. Imports no
JAX and nothing of the JAX package.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SET_B = dict(n=1 << 16, max_level=45, alpha=15)
LEVEL = 35
SCALE = 2.0**29
DATA = 2  # data rows of every mesh
BATCHES = (2, 4)  # one element a shard, two


def hmult_operands(torch, eng, cts):
    """(a, b, want) of four hmults over the ciphertexts cts = (c1, c2):
    the pairs (c1, c2), (c2, c1), (c1, c1), (c2, c2) stacked [4, 2,
    level, n2, n1], and their single-device hmults."""
    c1, c2 = cts
    pairs = ((c1, c2), (c2, c1), (c1, c1), (c2, c2))
    a = torch.stack([x.data for x, _ in pairs])
    b = torch.stack([y.data for _, y in pairs])
    return a, b, torch.stack([eng.hmult(x, y).data for x, y in pairs])


LABELS = ("coeff 2x4", "limb 2x4", "hybrid 2x(2x2)", "gspmd (2,2,2)")


def data_cases(eng, level, labels=LABELS):
    """{label: (mesh, axes, make, join)} of the data-axis hmults `labels`
    at `level` on eng's device: make(a, b) lays the batch [B, 2, level, n2,
    n1] out per shard (outside the call, as a caller holds it) and returns
    a no-argument call of the dispatch on it; join(out) is the gathered
    [B, 2, level-1, n2, n1]; axes are the (name, mesh axis) pairs whose
    collective calls are counted (None: a one-axis mesh's row)."""
    from homulator_tpu_torch.parallel import limb_sharded as ls
    from homulator_tpu_torch.parallel.comm import ThreadMesh
    from homulator_tpu_torch.parallel.mesh import make_mesh
    from homulator_tpu_torch.parallel.sharded import (
        gather_batch, make_sharded_hmult, make_shardmap_hmult, shard_batch,
        shard_cols,
    )

    dc, p, d = eng.dc, eng.params, DATA
    dev = dc.device

    def coeff():
        mesh = ThreadMesh(4, dev, data=d)
        f = make_shardmap_hmult(dc, level, mesh, data_axis="data")
        key = shard_cols(eng.relin_key, 4)

        def make(a, b):
            x, y = shard_batch(a, d, 4), shard_batch(b, d, 4)
            return lambda: f(x, y, key)
        return (mesh, (("coeff", None),), make,
                lambda out: gather_batch(out, d))

    def rows(nl, nc):
        if nc == 1:
            mesh = ThreadMesh(nl, dev, data=d, names=("limb",))
            f = ls.make_limb_hmult(dc, level, mesh, data_axis="data")
        else:
            mesh = ThreadMesh((nl, nc), dev, data=d,
                              names=("limb", "coeff"))
            f = ls.make_hybrid_hmult(dc, level, mesh, data_axis="data")
        key = ls.limb_key(eng.relin_key, p, level, nl, nc)

        def make(a, b):
            x, y = (ls.shard_rows(t, level, nl, nc, data=d) for t in (a, b))
            return lambda: f(x, y, key)
        return (mesh, tuple((ax, ax) for ax in mesh.names), make,
                lambda out: ls.gather_rows(out, nl, nc,
                                           data=d)[:, :, :level - 1])

    def gspmd():
        mesh = make_mesh((d, 2, 2), device=dev)
        f = make_sharded_hmult(dc, level, mesh)
        return (mesh, (("limb", "limb"), ("coeff", "coeff")),
                lambda a, b: lambda: f(a, b, eng.relin_key),
                lambda out: out)

    build = {"coeff 2x4": coeff, "limb 2x4": lambda: rows(4, 1),
             "hybrid 2x(2x2)": lambda: rows(2, 2), "gspmd (2,2,2)": gspmd}
    return {label: build[label]() for label in labels}


def run_case(torch, kernels, case, a, b):
    """One run of a data_cases entry on the batch (a, b), the counts set
    to 0 just before: ((gathered output, {kernel: launches}, {axis name:
    each shard's collective calls}, each shard's received bytes), the
    call, for timing)."""
    mesh, axes, make, join = case
    fn = make(a, b)
    mesh.reset_counts()
    kernels.reset_launch_counts()
    out = fn()
    if a.is_cuda:
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    return (join(out), launches,
            {name: mesh.calls(ax) for name, ax in axes}, mesh.recv_bytes), fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose homulator_tpu_torch is timed")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_data_axis_torch: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from homulator_tpu_torch import benchlib, kernels
    from homulator_tpu_torch.params import get_params
    from homulator_tpu_torch.workloads import native_engine

    if not benchlib.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {benchlib.__file__}, not from {root}")
    card = benchlib.card_line()
    print(card, flush=True)
    kernels.build()
    t0 = time.perf_counter()
    eng = native_engine(get_params(**SET_B), seed=1)
    eng.keygen()
    rng = np.random.default_rng(0)
    slots = eng.params.n // 2
    cts = [eng.encrypt_complex(rng.uniform(-0.5, 0.5, size=slots), LEVEL,
                               SCALE) for _ in range(2)]
    a, b, want = hmult_operands(torch, eng, cts)
    out = {"card": card, "root": root, "level": LEVEL, "data_rows": DATA,
           "host_setup_s": time.perf_counter() - t0, "runs": {}}
    for label, case in data_cases(eng, LEVEL).items():
        for B in BATCHES:
            (got, launches, calls, nbytes), fn = run_case(
                torch, kernels, case, a[:B], b[:B])
            if not torch.equal(got, want[:B]):
                raise AssertionError(f"{label} B={B}: != {B} single-device "
                                     "hmults")
            eager = benchlib.latency_ms(fn)
            device = benchlib.profiled_ms(fn)[0]
            run = {"eager_ms": eager, "device_ms": device,
                   "launches": {k: v for k, v in launches.items() if v},
                   "calls": {ax: c[0] for ax, c in calls.items()},
                   "recv_bytes": nbytes[0]}
            out["runs"][f"{label} B={B}"] = run
            print(f"# {label} B={B}: bit-exact; {json.dumps(run)}",
                  flush=True)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
