"""The port's hrotate, conjugate and hrotate_hoisted vs the JAX engine and
the exact numpy engine (`RefCkks.hrotate`), bit for bit (tolerance 0), at
the conftest's small parameters (n = 64, maxLevel 6, alpha 2: level 5 has
a partial digit), on the CPU (the kernels' plain versions).

Both engines take seed 21 and make their keys in the same order before
any encryption, so their keys are equal; ciphertexts are encrypted by the
JAX engine and cross through `from_jax_state`."""

import numpy as np
import pytest
import torch

from homulator_tpu.api import CkksEngine as JaxEngine
from homulator_tpu_torch.api import CkksEngine
from homulator_tpu_torch.context import Ciphertext, from_jax_state

SCALE = 2.0**29
STEPS = (1, -1, 3, 2)


@pytest.fixture(scope="module")
def engines(small_params):
    """(JAX engine, port engine on the CPU), keys made in the same order:
    relinearisation, rotations by STEPS, then conjugation."""
    jeng = JaxEngine(small_params, seed=21)
    eng = CkksEngine(small_params, seed=21, device="cpu")
    v = np.random.default_rng(0).normal(size=small_params.n // 2)
    for e in (jeng, eng):
        e.keygen()
        for s in STEPS:
            e.gen_rotation_key(s)
        e.conjugate(e.encrypt_complex(v, 6, SCALE))
    return jeng, eng


def _ct(jeng, eng, level, seed):
    """A JAX ciphertext of random slots and its port copy."""
    v = np.random.default_rng(seed).normal(size=jeng.params.n // 2)
    jct = jeng.encrypt_complex(v, level, SCALE)
    data = from_jax_state({"c": np.asarray(jct.data)}, eng.dc)["c"]
    return v, jct, Ciphertext(data, level, SCALE)


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("step", STEPS[:3])
def test_rotation_key_crosses_from_jax(engines, step):
    jeng, eng = engines
    key = from_jax_state({"k": np.asarray(jeng.rot_keys[step])}, eng.dc)["k"]
    assert key.dtype == torch.int32
    assert torch.equal(key, eng.rot_keys[step])


def test_conjugation_key_crosses_from_jax(engines):
    jeng, eng = engines
    g = eng.params.galois_conj
    key = from_jax_state({"k": np.asarray(jeng._conj_keys[g])}, eng.dc)["k"]
    assert torch.equal(key, eng._conj_keys[g])


@pytest.mark.parametrize("level", [6, 5])
@pytest.mark.parametrize("step", STEPS[:3])
def test_hrotate_matches_jax_and_ref(engines, level, step):
    jeng, eng = engines
    _, jct, ct = _ct(jeng, eng, level, seed=10 * level + step)
    out = eng.hrotate(ct, step)
    assert out.level == level and out.data.dtype == torch.int32
    assert np.array_equal(_u32(out.data),
                          np.asarray(jeng.hrotate(jct, step).data))
    ref = eng.ref.hrotate(eng.to_ref(ct), step)
    assert np.array_equal(eng.dc.download(out.data), ref.data)


@pytest.mark.parametrize("level", [6, 5])
def test_conjugate_matches_jax(engines, level):
    jeng, eng = engines
    v, jct, ct = _ct(jeng, eng, level, seed=40 + level)
    out = eng.conjugate(ct)
    assert np.array_equal(_u32(out.data), np.asarray(jeng.conjugate(jct).data))
    assert np.max(np.abs(eng.decrypt_complex(out) - np.conj(v))) < 1e-2


@pytest.mark.parametrize("level", [6, 5])
def test_hrotate_hoisted_matches_jax_and_single(engines, level):
    jeng, eng = engines
    _, jct, ct = _ct(jeng, eng, level, seed=50 + level)
    outs = eng.hrotate_hoisted(ct, list(STEPS[:3]))
    jouts = jeng.hrotate_hoisted(jct, list(STEPS[:3]))
    for s, o, jo in zip(STEPS, outs, jouts):
        assert np.array_equal(_u32(o.data), np.asarray(jo.data)), s
        assert torch.equal(o.data, eng.hrotate(ct, s).data), s


def test_hrotate_decrypts_to_rolled_slots(engines):
    """Every slot of the port's own encrypt -> hrotate chain, and a
    rotation at level 1 (no limb to drop) against RefCkks."""
    _, eng = engines
    v = np.random.default_rng(3).normal(size=eng.params.n // 2)
    ct = eng.encrypt_complex(v, 6, SCALE)
    for s in STEPS:
        got = eng.decrypt_complex(eng.hrotate(ct, s))
        assert np.max(np.abs(got - np.roll(v, -s))) < 1e-2, s
    low = eng.encrypt_complex(v, 1, SCALE)
    out = eng.hrotate(low, 1)
    ref = eng.ref.hrotate(eng.to_ref(low), 1)
    assert np.array_equal(eng.dc.download(out.data), ref.data)
    assert eng.stats.counters["op/hrotate"] >= len(STEPS) + 1
