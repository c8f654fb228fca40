#!/usr/bin/env python3
"""Automorphism bake-off on the card: flat gather, staged permutation and
one-hot product, at set B's hrotate shape.

    python3 scripts/bench_automorph_torch.py

The counterpart of scripts/bench_automorph.py (SURVEY.md section 7 step
5). Three forms of sigma_g (g of a rotation by one slot) on x [2 * 35,
256, 256] (hrotate's two components at level 35 of parameter set B),
held bit-identical before any timing:

  flat    one gather over the flattened 65536-slot axis
          (ops/automorph.py::automorph_eval, what hrotate runs)
  staged  a sublane, a lane and a sublane gather
          (ops/automorph.py::automorph_eval_staged, maps from
          ops/perm_decomp.py through DeviceContext.automorph_stage_maps)
  onehot  the staged form with both sublane stages as one-hot products
          of the input's byte planes in bf16: torch.einsum, as the JAX
          script's jnp.einsum outside any Pallas kernel; a one-hot row
          selects one plane byte, which bf16 holds exactly, so the sums
          are exact.

Each is timed as device time a call (CUDA-graph replay,
benchlib.device_ms), then hrotate(45, 35, 15) end to end (device time and
eager latency). One JSON line with the card's name and power limit.
Needs the card; imports no JAX and nothing of the JAX package.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

LEVEL = 35


def onehot_tables(s1, s3, n2: int):
    """The sublane stages' one-hot tables [r_out, s, c] in bf16 (oh[r, s,
    c] = 1 where the stage map sends row s of column c to row r), on the
    maps' device."""
    import torch

    rows = torch.arange(n2, device=s1.device)[None, :, None]
    return tuple((s[:, None, :] == rows).to(torch.bfloat16) for s in (s1, s3))


def _onehot_sub(y, oh):
    """out[m, r, c] = sum_s oh[r, s, c] * y[m, s, c] for int32 words y
    [M, R, C], one bf16 product a byte plane, reassembled exactly."""
    import torch

    planes = torch.stack([((y >> (8 * k)) & 0xFF).to(torch.bfloat16)
                          for k in range(4)])
    d = torch.einsum("rsc,pmsc->pmrc", oh, planes).to(torch.int32)
    return d[0] | (d[1] << 8) | (d[2] << 16) | (d[3] << 24)


def onehot_auto(y, oh1, s2, oh3):
    """sigma_g as automorph_eval_staged with its sublane stages as one-hot
    products (onehot_tables' oh1, oh3) and the lane stage a gather (s2
    int64 [n2, n1])."""
    import torch

    t1 = _onehot_sub(y, oh1)
    t2 = torch.take_along_dim(t1, s2[None], dim=-1)
    return _onehot_sub(t2, oh3)


def main() -> int:
    import torch

    from homulator_tpu_torch import benchlib, kernels
    from homulator_tpu_torch.ops.automorph import (
        automorph_eval, automorph_eval_staged,
    )
    from homulator_tpu_torch.params import get_params
    from homulator_tpu_torch.workloads import native_engine

    if not torch.cuda.is_available():
        raise SystemExit("bench_automorph_torch: needs a CUDA card")
    kernels.build()
    params = get_params(n=65536, max_level=45, alpha=15)
    eng = native_engine(params, seed=1)
    eng.keygen()
    g = params.galois_elt(1)
    perm = eng.dc.automorph_perm(g)
    s1, s2, s3 = eng.dc.automorph_stage_maps(g)
    t = params.ntt
    oh1, oh3 = onehot_tables(s1, s3, t.n2)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 1 << 30, size=(2 * LEVEL, t.n2, t.n1),
                                      dtype=np.int64).astype(np.int32)).cuda()
    forms = {"flat": lambda: automorph_eval(x, perm),
             "staged": lambda: automorph_eval_staged(x, s1, s2, s3),
             "onehot": lambda: onehot_auto(x, oh1, s2, oh3)}
    ref = forms["flat"]()
    for name, fn in forms.items():
        if not torch.equal(fn(), ref):
            raise AssertionError(f"{name} != flat")
    print(f"# all candidates bit-identical on {list(x.shape)}")
    res = {f"{k}_ms": benchlib.device_ms(fn) for k, fn in forms.items()}
    for k, v in res.items():
        print(f"{k:12s} {v:8.4f} ms per sigma_g on {list(x.shape)}")
    eng.gen_rotation_key(1)
    m = np.zeros(params.n, dtype=np.int64)
    m[0] = int(3 * 2.0**29)
    ct = eng.encrypt_ints(m, LEVEL, 2.0**29)
    hr = benchlib.hrotate_ms(eng, ct, 1)
    hr_eager = benchlib.hrotate_ms(eng, ct, 1, eager=True)
    print(f"hrotate(45,35,15) end-to-end: {hr:.4f} ms device, "
          f"{hr_eager:.4f} ms eager")
    print(json.dumps({"card": benchlib.card_line(), "automorph_bakeoff": res,
                      "shape": list(x.shape), "hrotate_ms": hr,
                      "hrotate_eager_ms": hr_eager}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
