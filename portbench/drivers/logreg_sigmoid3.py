"""Driver `logreg_sigmoid3`: logistic-regression inference on one encrypted
sample a request, `workloads.logreg_sigmoid3` as it stands.

Mix keys: `pool` (input ciphertexts the requests cycle through), `samples`
and `trace_requests` (harness).

Inputs from the seed: the weights w (one a slot, normal over the square
root of the slots, so that the score w . x stays well inside the
sigmoid's range), the bias b uniform in [-0.5, 0.5], and `pool` feature
vectors of N/2 normal entries, each encrypted at the configuration's
level and scale. Set-up makes the keys (the relinearisation key, then the
rotations by 1, 2, .., N/4, in that order) and `workloads.logreg_prep`'s
plaintexts and constants; a request is `workloads.logreg_sigmoid3` on one
input: the product by w, log2(N/2) dependent rotations at batch 1, + b,
the rescale, hsquare, hmult and the constants.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..counts import logistic as counts
from ..reference import logistic as ref_logistic
from ..reference.ckks import RefCkks


@dataclasses.dataclass
class Inputs:
    w: np.ndarray   # [slots]
    b: float
    xs: np.ndarray  # [pool, slots]


def pool(mix) -> int:
    return mix["pool"]


def make_inputs(rng, cfg, mix) -> Inputs:
    slots = cfg["n"] // 2
    return Inputs(rng.normal(size=slots) / np.sqrt(slots),
                  float(rng.uniform(-0.5, 0.5)),
                  rng.normal(size=(mix["pool"], slots)))


def program(env, inputs: Inputs):
    from homulator_tpu_torch import workloads

    cfg = env.config
    level, scale = cfg["level"], 2.0 ** cfg["scale_bits"]
    eng = env.engine()
    with env.span("keygen"):
        eng.keygen()
        for s in workloads.logreg_steps(cfg["n"] // 2):
            eng.gen_rotation_key(s)
    with env.span("encode"):
        prep = workloads.logreg_prep(eng, inputs.w, inputs.b, level, scale)
    with env.span("encrypt"):
        cts = [eng.encrypt_complex(x, level, scale).data for x in inputs.xs]
    p = len(cts)

    def request(i: int) -> torch.Tensor:
        return workloads.logreg_sigmoid3(cts[i % p], prep)

    return request


def reference(ref: RefCkks, cfg, mix, inputs: Inputs):
    """The reference's set-up (keys, plaintexts, encryptions); returns
    answer(k), the [2, level-3, N] int64 output of pool input k."""
    level, scale = cfg["level"], 2.0 ** cfg["scale_bits"]
    ref.keygen()
    prep = ref_logistic.logreg_prep(ref, inputs.w, inputs.b, level, scale)
    cts = [ref.encrypt(ref.encode_complex(x, level, scale), level)
           for x in inputs.xs]

    def answer(k: int) -> torch.Tensor:
        return ref_logistic.logreg_sigmoid3(ref, cts[k], prep)

    return answer


def work(cfg, mix) -> counts.Work:
    return counts.logreg_sigmoid3(cfg["n"], cfg["level"], cfg["alpha"])
