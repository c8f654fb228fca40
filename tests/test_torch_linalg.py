"""The port's encrypted linear algebra (homulator_tpu_torch.linalg) on the
port's engine (CPU, the graph route as tests/test_linalg.py's JAX engine)
against the clear computation, with tests/test_linalg.py's cases and its
1e-2 gates; and the BSGS matvec bit for bit (tolerance 0) against the JAX
package's linalg on a JAX engine of the same seed, whose keys and
ciphertexts the port's host engine makes identically."""

import numpy as np
import pytest

from homulator_tpu import linalg as jax_linalg
from homulator_tpu.api import CkksEngine as JaxEngine
from homulator_tpu.params import get_params
from homulator_tpu_torch import linalg
from homulator_tpu_torch.api import CkksEngine

PARAMS = dict(n=256, max_level=8, alpha=4)


@pytest.fixture(scope="module")
def eng():
    e = CkksEngine(get_params(**PARAMS), seed=17, device="cpu",
                   ntt_mode="jnp")
    e.keygen()
    return e


def test_bsgs_matvec(eng):
    d, level, scale = 16, 6, 2.0**26
    rng = np.random.default_rng(5)
    M = rng.normal(size=(d, d)) / d
    x = rng.normal(size=d)
    ct = linalg.encrypt_vector(eng, x, level, scale)
    out = linalg.bsgs_matvec(eng, ct, M)
    assert out.level == level - 1
    y = eng.decrypt_complex(out).real[:d]
    assert np.max(np.abs(y - M @ x)) < 1e-2


def test_bsgs_matvec_g1(eng):
    """g=1 (no baby steps, all giant rotations) stays correct."""
    d, level, scale = 8, 6, 2.0**26
    rng = np.random.default_rng(6)
    M = rng.normal(size=(d, d)) / d
    x = rng.normal(size=d)
    ct = linalg.encrypt_vector(eng, x, level, scale)
    y = eng.decrypt_complex(
        linalg.bsgs_matvec(eng, ct, M, g=1)).real[:d]
    assert np.max(np.abs(y - M @ x)) < 1e-2


def test_sum_slots(eng):
    level, scale = 6, 2.0**26
    slots = eng.params.n // 2
    rng = np.random.default_rng(7)
    v = rng.normal(size=slots) / np.sqrt(slots)
    ct = eng.encrypt_complex(v, level, scale)
    out = linalg.sum_slots(eng, ct)
    got = eng.decrypt_complex(out).real
    assert np.max(np.abs(got - v.sum())) < 1e-2


def test_dot_with_bias(eng):
    level, scale = 6, 2.0**26
    slots = eng.params.n // 2
    rng = np.random.default_rng(8)
    x = rng.normal(size=slots) / np.sqrt(slots)
    w = rng.normal(size=slots) / np.sqrt(slots)
    ct = eng.encrypt_complex(x, level, scale)
    out = linalg.dot(eng, ct, w, bias=0.25)
    assert out.level == level - 1
    got = eng.decrypt_complex(out)[0].real
    assert abs(got - (np.dot(x, w) + 0.25)) < 1e-2


@pytest.mark.parametrize("mode", ["auto", "jnp"])
def test_bsgs_matvec_bits_match_jax(mode):
    """The same seed, the same calls: the same keys, ciphertexts and
    result bits on both packages (the port on either route)."""
    d, level, scale = 16, 6, 2.0**26
    rng = np.random.default_rng(9)
    M = rng.normal(size=(d, d)) / d
    x = rng.normal(size=d)
    p = get_params(**PARAMS)
    outs = []
    for e, lib in ((JaxEngine(p, seed=23, ntt_mode="jnp"), jax_linalg),
                   (CkksEngine(p, seed=23, device="cpu", ntt_mode=mode),
                    linalg)):
        e.keygen()
        ct = lib.encrypt_vector(e, x, level, scale)
        outs.append(lib.bsgs_matvec(e, ct, M))
    want, got = outs
    assert (got.level, got.scale) == (want.level, want.scale)
    assert np.array_equal(got.data.numpy().view(np.uint32),
                          np.asarray(want.data))
