"""Driver `hmult_batch`: a batch of independent ciphertext products.

Mix keys: `batch` (products a request), `pool_batches` (distinct batches
the requests cycle through), `samples` and `trace_requests` (harness).

Inputs: 2 x batch ciphertexts of N/2 normal slots at the configuration's
level and scale; batch k multiplies the first half of a permutation of
them (drawn from the seed) by the second half. The port encrypts them
with its engine (keys and encryption from the run's seed), and a request
is `api.hmult_graph` on the stacked batch [batch, 2, level, n2, n1] with
the relinearisation key: one program for the batch.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..counts import work as counts
from ..reference.ckks import RefCkks


@dataclasses.dataclass
class Inputs:
    values: np.ndarray        # [2 * batch, slots]
    pairs: List[np.ndarray]   # per pool batch, a permutation of 2 * batch


def pool(mix) -> int:
    return mix["pool_batches"]


def make_inputs(rng, cfg, mix) -> Inputs:
    b = mix["batch"]
    values = rng.normal(size=(2 * b, cfg["n"] // 2))
    return Inputs(values, [rng.permutation(2 * b)
                           for _ in range(mix["pool_batches"])])


def program(env, inputs: Inputs):
    from homulator_tpu_torch import api

    cfg, b = env.config, env.mix["batch"]
    level, scale = cfg["level"], 2.0 ** cfg["scale_bits"]
    eng = env.engine()
    with env.span("keygen"):
        eng.keygen()
    with env.span("encrypt"):
        cts = [eng.encrypt_complex(v, level, scale).data
               for v in inputs.values]
    a = [torch.stack([cts[i] for i in p[:b]]) for p in inputs.pairs]
    bb = [torch.stack([cts[i] for i in p[b:]]) for p in inputs.pairs]
    del cts
    kt = eng.dc.keyswitch_tables(level)
    key = eng.relin_key
    p = len(inputs.pairs)

    def request(i: int) -> torch.Tensor:
        return api.hmult_graph(a[i % p], bb[i % p], key, kt)

    return request


def reference(ref: RefCkks, cfg, mix, inputs: Inputs):
    """The reference's set-up (keys, encryptions); returns answer(k), the
    [batch, 2, level-1, N] int64 product of pool batch k."""
    b, level = mix["batch"], cfg["level"]
    scale = 2.0 ** cfg["scale_bits"]
    ref.keygen()
    cts = [ref.encrypt(ref.encode_complex(v, level, scale), level)
           for v in inputs.values]

    def answer(k: int) -> torch.Tensor:
        p = inputs.pairs[k]
        return torch.stack([ref.hmult(cts[i], cts[j], level)
                            for i, j in zip(p[:b], p[b:])])

    return answer


def work(cfg, mix) -> counts.Work:
    return counts.hmult_batch(cfg["n"], cfg["level"], cfg["alpha"],
                              mix["batch"])
