"""Driver `matvec_bsgs`: one encrypted dense layer a request, y = M x.

Mix keys: `d` (M is d x d), `g` (giant step), `pool` (input ciphertexts
the requests cycle through), `samples` and `trace_requests` (harness).

Inputs: M with normal entries over d, and `pool` vectors of d normal
entries, each tiled over the slots and encrypted at the configuration's
level and scale (the recipe of chip_smoke.py's phase 7). Set-up makes the
keys (the relinearisation key, then one rotation key a step: 1 .. g-1,
then g, 2g, .. d-g, in that order) and `workloads.matvec_prep`'s d
diagonal plaintexts; a request is `workloads.matvec_bsgs` on one input:
hoisted baby rotations, plaintext products and adds, giant rotations.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..counts import work as counts
from ..reference import workloads as ref_workloads
from ..reference.ckks import RefCkks


@dataclasses.dataclass
class Inputs:
    M: np.ndarray   # [d, d]
    xs: np.ndarray  # [pool, d]


def steps(mix):
    d, g = mix["d"], mix["g"]
    return list(range(1, g)) + [g * j for j in range(1, d // g)]


def _slots(x: np.ndarray, n: int) -> np.ndarray:
    return np.tile(x, (n // 2) // x.shape[0])


def pool(mix) -> int:
    return mix["pool"]


def make_inputs(rng, cfg, mix) -> Inputs:
    d = mix["d"]
    return Inputs(rng.normal(size=(d, d)) / d,
                  rng.normal(size=(mix["pool"], d)))


def program(env, inputs: Inputs):
    from homulator_tpu_torch import workloads

    cfg, mix = env.config, env.mix
    n, level, scale = cfg["n"], cfg["level"], 2.0 ** cfg["scale_bits"]
    eng = env.engine()
    with env.span("keygen"):
        eng.keygen()
        for s in steps(mix):
            eng.gen_rotation_key(s)
    with env.span("encode"):
        prep = workloads.matvec_prep(eng, inputs.M, level, scale, mix["g"])
    with env.span("encrypt"):
        cts = [eng.encrypt_complex(_slots(x, n), level, scale).data
               for x in inputs.xs]
    p = len(cts)

    def request(i: int) -> torch.Tensor:
        return workloads.matvec_bsgs(cts[i % p], prep)

    return request


def reference(ref: RefCkks, cfg, mix, inputs: Inputs):
    """The reference's set-up (keys, diagonals, encryptions); returns
    answer(k), the [2, level, N] int64 matvec of pool input k."""
    n, level = cfg["n"], cfg["level"]
    scale = 2.0 ** cfg["scale_bits"]
    d, g = mix["d"], mix["g"]
    ref.keygen()
    for s in steps(mix):
        ref.gen_rotation_key(s)
    pts = [ref.encode_complex(v, level, scale)
           for v in ref_workloads.bsgs_diagonals(inputs.M, g, n // 2)]
    cts = [ref.encrypt(ref.encode_complex(_slots(x, n), level, scale), level)
           for x in inputs.xs]

    def answer(k: int) -> torch.Tensor:
        return ref_workloads.matvec_bsgs(ref, cts[k], pts, d, g, level)

    return answer


def work(cfg, mix) -> counts.Work:
    return counts.matvec_bsgs(cfg["n"], cfg["level"], cfg["alpha"], mix["d"],
                              mix["g"])
