#!/usr/bin/env python3
"""The control of portbench's check: the plain reference put in the
program's place, computed one precision below the configuration's.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ..]
        [--seconds <s>] [--device cuda|cpu]

For each seed it makes one run of the cell (`harness.cell.run_cell`: set-up,
warm-up, a closed-loop window of `--seconds`, the same sampled answers and
the same comparison as a benchmark run) with the measured program replaced
by `reference.ckks.RefCkks(exact=False)`: every modular product in float64
(a 53-bit mantissa) where the configuration states exact 64-bit integer
products of 30-bit residues. It prints each run's `checks` and `correct`,
one line a seed, and last a JSON line with all readings: the upper reading
of the check's limit, which is 0 (an exact comparison). The benchmark's own
runs never run it.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def program(env, inputs):
    """The control in the program's place: the reference's set-up from the
    run's seed with float64 products; request i computes pool entry i's
    answer in the program's tile layout [..., 1, N]."""
    from portbench.reference.ckks import RefCkks
    from portbench.reference.params import get_params

    c, mx = env.config, env.mix
    driver = importlib.import_module(f"portbench.drivers.{mx['op']}")
    ref = RefCkks(get_params(c["n"], c["max_level"], c["alpha"],
                             c["scale_bits"]), env.seed, env.device,
                  exact=False)
    with env.span("keygen"):
        answer = driver.reference(ref, c, mx, inputs)
    pool = driver.pool(mx)
    return lambda i: answer(i % pool).unsqueeze(-2)


def control_run(root: str, cell_name: str, seed: int, seconds: float,
                device: str, config=None, mix=None) -> dict:
    """One run of the cell with the control in the program's place."""
    from portbench.harness import cell

    return cell.run_cell(root, cell_name, seed, seconds, False, device,
                         time.perf_counter(), config=config, mix=mix,
                         program=program)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    readings = {}
    for seed in args.seeds:
        t = time.perf_counter()
        r = control_run(ROOT, args.workload, seed % 2 ** 64, args.seconds,
                        args.device)
        readings[seed] = r["checks"]["wrong_words"]["value"]
        print(f"control {args.workload} seed {seed}: correct {r['correct']}"
              f", checks {json.dumps(r['checks'])} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    print(json.dumps({"workload": args.workload, "control_wrong_words":
                      readings, "min": min(readings.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
