"""The port's engine surface on both key-switch routes (`ntt_mode` "auto"
and "jnp") vs the JAX `CkksEngine(ntt_mode="jnp")`, bit for bit
(tolerance 0), at the conftest's small_params (n = 64, maxLevel 6,
alpha 2): plaintext_ints / plaintext_complex, hadd, hsub, padd, pmult,
cmult, cadd, mod_drop, align_levels, keyswitch_poly, rescale, the ntt /
intt host views, the key-switching ops at levels 6 and 5, and the
Statistic counters. JAX ciphertexts and keys cross through
`from_jax_state`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu.api import CkksEngine as JaxEngine
from homulator_tpu_torch.api import CkksEngine
from homulator_tpu_torch.context import Ciphertext, Plaintext, from_jax_state

SCALE = 2.0**29
MODES = ["auto", "jnp"]


@pytest.fixture(scope="module")
def jeng(small_params):
    e = JaxEngine(small_params, seed=7, ntt_mode="jnp")
    e.keygen()
    e.gen_rotation_key(1)
    e.gen_rotation_key(2)
    e.conjugate(e.encrypt_complex(np.zeros(small_params.n // 2), 2, SCALE))
    return e


@pytest.fixture(scope="module", params=MODES)
def engines(request, jeng):
    """(JAX engine, port engine on the CPU in one mode, holding the JAX
    engine's keys)."""
    eng = CkksEngine(jeng.params, seed=7, device="cpu", ntt_mode=request.param)
    keys = from_jax_state(
        {"relin": np.asarray(jeng.relin_key), "r1": np.asarray(jeng.rot_keys[1]),
         "r2": np.asarray(jeng.rot_keys[2]),
         "conj": np.asarray(jeng._conj_keys[jeng.params.galois_conj])},
        eng.dc)
    eng.relin_key = keys["relin"]
    eng.rot_keys = {1: keys["r1"], 2: keys["r2"]}
    eng._conj_keys = {jeng.params.galois_conj: keys["conj"]}
    return jeng, eng


def _u32(t):
    return t.numpy().view(np.uint32)


def _same(tct, jct):
    assert (tct.level, tct.scale, tct.domain) == (jct.level, jct.scale,
                                                 jct.domain)
    assert np.array_equal(_u32(tct.data), np.asarray(jct.data))


def _cts(jeng, eng, level, seed, k=2):
    """k JAX ciphertexts of random slots and their port copies."""
    rng = np.random.default_rng(seed)
    jct = [jeng.encrypt_complex(rng.normal(size=jeng.params.n // 2), level,
                                SCALE) for _ in range(k)]
    st = from_jax_state({str(i): np.asarray(c.data)
                         for i, c in enumerate(jct)}, eng.dc)
    return jct, [Ciphertext(st[str(i)], level, SCALE) for i in range(k)]


def _pt(jeng, eng, level, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=jeng.params.n // 2)
    jpt = jeng.plaintext_complex(v, level, SCALE)
    pt = eng.plaintext_complex(v, level, SCALE)
    assert isinstance(pt, Plaintext) and pt.level == level
    assert np.array_equal(_u32(pt.data), np.asarray(jpt.data))
    return jpt, pt


def test_plaintext_ints_matches_jax(engines):
    jeng, eng = engines
    m = np.arange(jeng.params.n, dtype=np.int64) * 1000 - 7
    want = jeng.plaintext_ints(m, 5, SCALE)
    got = eng.plaintext_ints(m, 5, SCALE)
    assert np.array_equal(_u32(got.data), np.asarray(want.data))
    assert (got.level, got.scale) == (want.level, want.scale)


@pytest.mark.parametrize("op", ["hadd", "hsub"])
def test_hadd_hsub_match_jax(engines, op):
    jeng, eng = engines
    (ja, jb), (a, b) = _cts(jeng, eng, 6, seed=1)
    _same(getattr(eng, op)(a, b), getattr(jeng, op)(ja, jb))


@pytest.mark.parametrize("op", ["padd", "pmult"])
def test_padd_pmult_match_jax(engines, op):
    jeng, eng = engines
    (ja,), (a,) = _cts(jeng, eng, 5, seed=2, k=1)
    jpt, pt = _pt(jeng, eng, 5, seed=3)
    _same(getattr(eng, op)(a, pt), getattr(jeng, op)(ja, jpt))


@pytest.mark.parametrize("value", [0.75, -1.5])
def test_cmult_cadd_match_jax(engines, value):
    jeng, eng = engines
    (ja,), (a,) = _cts(jeng, eng, 4, seed=4, k=1)
    _same(eng.cmult(a, value), jeng.cmult(ja, value))
    _same(eng.cmult(a, value, scale_bits=20), jeng.cmult(ja, value, 20))
    _same(eng.cadd(a, value), jeng.cadd(ja, value))


def test_mod_drop_align_rescale_match_jax(engines):
    jeng, eng = engines
    (ja, jb), (a, b) = _cts(jeng, eng, 6, seed=5)
    _same(eng.mod_drop(a, 2), jeng.mod_drop(ja, 2))
    jd = jeng.mod_drop(jb, 1)
    for tx, jx in zip(eng.align_levels(a, eng.mod_drop(b, 1)),
                      jeng.align_levels(ja, jd)):
        _same(tx, jx)
    for tx, jx in zip(eng.align_levels(eng.mod_drop(b, 1), a),
                      jeng.align_levels(jd, ja)):
        _same(tx, jx)
    _same(eng.rescale(a), jeng.rescale(ja))
    _same(eng.rescale(eng.mod_drop(a, 1)), jeng.rescale(jeng.mod_drop(ja, 1)))
    with pytest.raises(ValueError):
        eng.mod_drop(a, 6)


@pytest.mark.parametrize("level", [6, 5])
def test_keyswitch_poly_matches_jax(engines, level):
    jeng, eng = engines
    (ja,), (a,) = _cts(jeng, eng, level, seed=6, k=1)
    want = jeng.keyswitch_poly(ja.data[1], jeng.rot_keys[1], level)
    got = eng.keyswitch_poly(a.data[1], eng.rot_keys[1], level)
    assert np.array_equal(_u32(got), np.asarray(want))


def test_ntt_intt_views_match_jax(engines):
    jeng, eng = engines
    p = jeng.params
    rng = np.random.default_rng(8)
    x = np.stack([rng.integers(0, int(q), size=p.n) for q in
                  p.q_arr[:p.max_level]]).astype(np.uint32)
    y = eng.ntt(torch.from_numpy(x.view(np.int32)), p.max_level)
    want = np.asarray(jeng.ntt(jnp.asarray(x), p.max_level))
    assert np.array_equal(_u32(y), want)
    back = eng.intt(y, p.max_level)
    assert np.array_equal(_u32(back),
                          np.asarray(jeng.intt(jnp.asarray(want), p.max_level)))
    assert np.array_equal(_u32(back), x)


@pytest.mark.parametrize("level", [6, 5])
def test_keyswitch_ops_match_jax(engines, level):
    """hmult, hsquare, hrotate, conjugate and hrotate_hoisted on this
    engine's route against the JAX graph route."""
    jeng, eng = engines
    (ja, jb), (a, b) = _cts(jeng, eng, level, seed=9 + level)
    _same(eng.hmult(a, b), jeng.hmult(ja, jb))
    _same(eng.hsquare(a), jeng.hsquare(ja))
    _same(eng.hrotate(a, 1), jeng.hrotate(ja, 1))
    _same(eng.conjugate(a), jeng.conjugate(ja))
    for t, j in zip(eng.hrotate_hoisted(a, [1, 2]),
                    jeng.hrotate_hoisted(ja, [1, 2])):
        _same(t, j)


def test_stats_counters_match_jax(small_params, engines):
    """The same op sequence counts the same Statistic keys and values."""
    jeng, eng = engines
    j2 = JaxEngine(small_params, seed=7, ntt_mode="jnp")
    j2.relin_key, j2.rot_keys = jeng.relin_key, jeng.rot_keys
    t2 = CkksEngine(small_params, seed=7, device="cpu",
                    ntt_mode=eng.dc.ntt_mode)
    t2.relin_key, t2.rot_keys = eng.relin_key, eng.rot_keys
    (ja, jb), (a, b) = _cts(jeng, eng, 4, seed=20)
    jpt, pt = _pt(jeng, eng, 4, seed=21)
    for e, x, y, p in ((j2, ja, jb, jpt), (t2, a, b, pt)):
        e.hadd(x, y)
        e.hsub(x, y)
        e.padd(x, p)
        e.pmult(x, p)
        e.hmult(x, y)
        e.hsquare(x)
        e.hrotate(x, 1)
    assert t2.stats.counters == j2.stats.counters
