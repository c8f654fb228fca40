#!/usr/bin/env python3
"""hrotate(45, 35, 15)'s phases on the card, each timed alone.

    python3 scripts/profile_hrotate_torch.py

The counterpart of scripts/profile_hrotate.py at parameter set B (N =
2^16, level 35), rotation by one slot. Phases, as api.hrotate_graph runs
them: both components' automorphism gathers (automorph_eval on c0 and
c1), the key switch of sigma(c1) (ModUp, inner product and the batched
ModDown pair: keyswitch_pieces, or on the fused route modup_convs_coeff,
B4's hpip_acc and the ModDown pair, keyswitch_fused), within it the
batched ModDown pair alone (moddown_pair2), and the final add of c0's
part. Each is timed alone as device time (CUDA-graph replay,
benchlib.device_ms) on the piecewise and on the fused HPIP route, beside
the whole hrotate, and the sum of the automorphism, the key switch and
the add is compared with it. One JSON line with the card's name and
power limit. Needs the card; imports no JAX and nothing of the JAX
package.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

LEVEL = 35


def main() -> int:
    import torch

    from homulator_tpu_torch import api, benchlib, kernels
    from homulator_tpu_torch.api import hrotate_graph
    from homulator_tpu_torch.ops.automorph import automorph_eval
    from homulator_tpu_torch.ops.keyswitch import (
        inner_product_pieces, keyswitch_fused, keyswitch_pieces,
        moddown_pair2, modup_conv_all,
    )
    from homulator_tpu_torch.ops.modmath import col, modadd
    from homulator_tpu_torch.params import get_params
    from homulator_tpu_torch.workloads import native_engine

    if not torch.cuda.is_available():
        raise SystemExit("profile_hrotate_torch: needs a CUDA card")
    kernels.build()
    params = get_params(n=1 << 16, max_level=45, alpha=15)
    eng = native_engine(params, seed=1)
    eng.keygen()
    eng.gen_rotation_key(1)
    kt = eng.dc.keyswitch_tables(LEVEL)
    rotk = eng.rot_keys[1]
    perm = eng.dc.automorph_perm(params.galois_elt(1))
    rng = np.random.default_rng(0)
    m = np.zeros(params.n, dtype=np.int64)
    m[: params.n // 2] = rng.integers(-100, 100, size=params.n // 2)
    a = eng.encrypt_ints(m, LEVEL, 2.0**29).data
    x = a[1]
    acc0, acc1 = inner_product_pieces(modup_conv_all(x, kt), x, rotk, kt)
    r0, e0 = automorph_eval(a[0], perm), keyswitch_pieces(x, rotk, kt)[0]
    q = col(kt.main_nt.q)

    out = {"card": benchlib.card_line(), "backend": "cuda",
           "shape": "L=45 l=35 alpha=15", "step": 1}
    for route in ("piecewise", "fused"):
        api.USE_FUSED_HPIP = route == "fused"
        ks = keyswitch_fused if route == "fused" else keyswitch_pieces
        phases = {
            "hrotate (full)": lambda: hrotate_graph(a, perm, rotk, kt),
            "automorph x2": lambda: (automorph_eval(a[0], perm),
                                     automorph_eval(a[1], perm)),
            "keyswitch (modup + ip + moddown pair)": lambda: ks(x, rotk, kt),
            "moddown pair2 (both keys)": lambda: moddown_pair2(acc0, acc1,
                                                               kt),
            "add": lambda: modadd(r0, e0, q).to(torch.int32),
        }
        try:
            ms = {k: benchlib.device_ms(fn) for k, fn in phases.items()}
        finally:
            api.USE_FUSED_HPIP = False
        parts = ("automorph x2", "keyswitch (modup + ip + moddown pair)",
                 "add")
        for k, v in ms.items():
            print(f"# {route} {k:40s} {v:8.4f} ms")
        total = sum(ms[k] for k in parts)
        print(f"# {route} sum of automorph, keyswitch and add "
              f"{total:.4f} ms against the whole {ms['hrotate (full)']:.4f}")
        out[route] = dict(ms, sum_of_phases=total)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
