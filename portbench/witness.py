#!/usr/bin/env python3
"""A second witness for the plain reference: its answer on the card against
its answer on the CPU.

    python3 portbench/witness.py --workload <cell> --seeds <n> [<n> ..]

The check runs `reference.ckks` on the card, through torch's int64 CUDA
kernels, the same kernels behind the measured program's elementwise glue.
A fault common to both would pass an exact comparison. This script
computes one pool entry of the cell at its own size, drawn from the seed,
with the reference on the card and on the CPU (torch's CPU kernels), and
prints the words that differ, one line a seed, then a JSON line. The
benchmark's own runs never run it.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def witness(root: str, cell_name: str, seed: int,
            devices=("cuda", "cpu"), config=None, mix=None) -> dict:
    import numpy as np

    from portbench.harness import manifest
    from portbench.reference.ckks import RefCkks
    from portbench.reference.params import get_params

    man = manifest.load(root)
    cell = manifest.cell(man, cell_name)
    cfg = config or manifest.config(root, man, cell["config"])
    mx = mix or manifest.mix(root, cell["traffic"])
    driver = importlib.import_module(f"portbench.drivers.{mx['op']}")
    params = get_params(cfg["n"], cfg["max_level"], cfg["alpha"],
                        cfg["scale_bits"])
    inputs = driver.make_inputs(np.random.default_rng([seed, 1]), cfg, mx)
    k = int(np.random.default_rng([seed, 3]).integers(driver.pool(mx)))
    out, secs = [], []
    for dev in devices:
        t = time.perf_counter()
        ref = RefCkks(params, seed, dev)
        out.append(driver.reference(ref, cfg, mx, inputs)(k).cpu())
        secs.append(time.perf_counter() - t)
        del ref
    return {"workload": cell_name, "seed": seed, "entry": k,
            "words": out[0].numel(),
            "wrong_words": int((out[0] != out[1]).sum()),
            "seconds": dict(zip(devices, secs))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    rows = [witness(ROOT, args.workload, s % 2 ** 64) for s in args.seeds]
    for r in rows:
        print(f"witness {json.dumps(r)}", flush=True)
    print(json.dumps({"workload": args.workload, "wrong_words":
                      sum(r["wrong_words"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
