#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on one CUDA GPU and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. Prints, as the last line of standard output,
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), `device`,
with --trace 1 `breakdown`, and last `checks`, the numbers compared with
the plain reference beside their limits (also the last lines of standard
error). Exits non-zero and prints no result when there is no CUDA device,
fewer than the cell asks for, a module of JAX or of the JAX package is
loaded after the window, or the port cannot be imported.

The port's build caches stay inside the checkout: nvcc's objects in
build/kernels/, the native core in build/native/ (the port's own fixed
paths); torch's extension and Triton caches, if anything asks for them,
under build/portbench/.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = os.path.join(ROOT, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, ROOT)
    import torch

    from portbench.harness import cell, manifest

    entry = manifest.cell(manifest.load(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} GPUs, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        # numpy's generators take non-negative seeds of any size
        result = cell.run_cell(ROOT, args.workload, args.seed % 2 ** 64,
                               args.seconds, bool(args.trace), "cuda", T0)
    except cell.RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    bad = cell.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or of the JAX package loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    print(f"portbench: {result['device'].get('power')}; reference "
          f"{result['reference_s']:.1f} s", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k}: {v}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
