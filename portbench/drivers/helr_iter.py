"""Driver `helr_iter`: one iteration of HELR, encrypted logistic-regression
training by Nesterov's accelerated gradient, a request.

Configuration keys besides the parameter set: `minibatch` (samples an
iteration), `features` (slots a sample: 1 + `inputs`, zero-padded),
`inputs` (features a sample before the bias), `blocks` (ciphertexts a
mini-batch), `gamma` and `eta` (the step's learning rate and momentum).
Mix keys: `pool` (mini-batches the requests cycle through: one epoch),
`samples` and `trace_requests` (harness).

Inputs from the seed: `pool` mini-batches of z_i = y_i (1, x_i), x_i
uniform in [-1, 1]^inputs, y_i = +-1; beta and v normal with standard
deviation 0.05 on the first 1 + inputs slots of a row, so that |z_i . v|
stays well inside the sigmoid's range. Block k of a mini-batch holds
samples k rows .. (k+1) rows - 1, one a row of `features` slots. Set-up
makes the keys (the relinearisation key, then the rotations of
`workloads.helr_steps`), `workloads.helr_prep`'s mask and constants, and
encrypts beta, v and every block at the configuration's level and scale
(all resident, as a server training on one client's epoch holds them).
A request is `workloads.helr_iteration` on mini-batch i mod pool from the
same beta and v: each step one op on all blocks. Its answer is beta' and
v', stacked.
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
    z: np.ndarray     # [pool, minibatch, features]
    beta: np.ndarray  # [features]
    v: np.ndarray     # [features]


def _rows(cfg) -> int:
    return cfg["minibatch"] // cfg["blocks"]


def _blocks(cfg, z: np.ndarray):
    """The slot vectors of a mini-batch's blocks: row-major rows."""
    r = _rows(cfg)
    return [z[k * r:(k + 1) * r].reshape(-1) for k in range(cfg["blocks"])]


def _tiled(cfg, w: np.ndarray) -> np.ndarray:
    return np.tile(w, _rows(cfg))


def pool(mix) -> int:
    return mix["pool"]


def make_inputs(rng, cfg, mix) -> Inputs:
    m, f, d = cfg["minibatch"], cfg["features"], cfg["inputs"]
    z = np.zeros((mix["pool"], m, f))
    y = rng.choice([-1.0, 1.0], size=(mix["pool"], m))
    z[:, :, 0] = y
    z[:, :, 1:d + 1] = y[..., None] * rng.uniform(-1, 1, size=(mix["pool"],
                                                                m, d))
    w = np.zeros((2, f))
    w[:, :d + 1] = rng.normal(0, 0.05, size=(2, d + 1))
    return Inputs(z, w[0], w[1])


def _prep_args(cfg):
    return (cfg["level"], 2.0 ** cfg["scale_bits"], _rows(cfg),
            cfg["features"], cfg["blocks"], cfg["gamma"], cfg["eta"])


def program(env, inputs: Inputs):
    from homulator_tpu_torch import workloads

    cfg = env.config
    level, scale = cfg["level"], 2.0 ** cfg["scale_bits"]
    steps = workloads.helr_steps(_rows(cfg), cfg["features"])
    eng = env.engine()
    with env.span("keygen"):
        eng.keygen()
        for group in steps:
            for s in group:
                eng.gen_rotation_key(s)
    with env.span("encode"):
        prep = workloads.helr_prep(eng, *_prep_args(cfg))
    with env.span("encrypt"):
        beta, v = (eng.encrypt_complex(_tiled(cfg, w), level, scale).data
                   for w in (inputs.beta, inputs.v))
        Z = [torch.stack([eng.encrypt_complex(b, level, scale).data
                          for b in _blocks(cfg, z)]) for z in inputs.z]
    p = len(Z)

    def request(i: int) -> torch.Tensor:
        return workloads.helr_iteration(Z[i % p], beta, v, prep)

    return request


def reference(ref: RefCkks, cfg, mix, inputs: Inputs):
    """The reference's set-up (keys, mask and constants, encryptions in
    the program's order); returns answer(k), beta' and v' of mini-batch k
    stacked, [2, 2, level-6, N] int64."""
    level, scale = cfg["level"], 2.0 ** cfg["scale_bits"]
    ref.keygen()
    prep = ref_logistic.helr_prep(ref, *_prep_args(cfg))
    beta, v = (ref.encrypt(ref.encode_complex(_tiled(cfg, w), level, scale),
                           level) for w in (inputs.beta, inputs.v))
    Z = [[ref.encrypt(ref.encode_complex(b, level, scale), level)
          for b in _blocks(cfg, z)] for z in inputs.z]

    def answer(k: int) -> torch.Tensor:
        return torch.stack(ref_logistic.helr_iteration(ref, Z[k], beta, v,
                                                       prep))

    return answer


def work(cfg, mix) -> counts.Work:
    return counts.helr_iter(cfg["n"], cfg["level"], cfg["alpha"], _rows(cfg),
                            cfg["features"], cfg["blocks"])
