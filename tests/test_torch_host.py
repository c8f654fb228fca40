"""The port's own copies of the numpy host modules (`params`, `numtheory`,
`refimpl`, `encoder`, `config`, `stats`) against the JAX package's, exactly
(tolerance 0): every precomputed table, the automorphism gathers, and the
keys and ciphertexts the reference engine makes from one seed."""

import dataclasses

import numpy as np
import pytest

from homulator_tpu import config as jconfig
from homulator_tpu import encoder as jencoder
from homulator_tpu import numtheory as jnt
from homulator_tpu import params as jparams
from homulator_tpu import refimpl as jrefimpl
from homulator_tpu import stats as jstats
from homulator_tpu_torch import config, encoder, numtheory, params, refimpl, stats

SHAPES = [(64, 6, 2), (128, 5, 3)]  # conftest's small and medium params


def assert_same(a, b, path="params"):
    """a and b hold equal values: arrays bit for bit with the same dtype,
    dataclasses and plain objects field by field."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        assert a.shape == b.shape and np.array_equal(a, b), path
    elif dataclasses.is_dataclass(a) or hasattr(a, "__dict__"):
        assert sorted(vars(a)) == sorted(vars(b)), path
        for k in vars(a):
            assert_same(vars(a)[k], vars(b)[k], f"{path}.{k}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("shape", SHAPES)
def test_params_tables_equal(shape):
    """Primes, Montgomery constants, NTT tables, key-switch and rescale
    tables: every field of CkksParams."""
    n, L, a = shape
    jp = jparams.CkksParams(n=n, max_level=L, alpha=a)
    tp = params.CkksParams(n=n, max_level=L, alpha=a)
    assert_same(jp, tp)
    assert tp.ks.modup_step2 and tp.ntt.tw_mid.shape == (L + a, tp.ntt.n1,
                                                         tp.ntt.n2)


@pytest.mark.parametrize("shape", SHAPES)
def test_automorph_perms_equal(shape):
    jp, tp = jparams.get_params(*shape), params.get_params(*shape)
    steps = (1, -1, 3)
    assert [jp.galois_elt(s) for s in steps] == [tp.galois_elt(s)
                                                 for s in steps]
    assert jp.galois_conj == tp.galois_conj
    for g in [tp.galois_elt(s) for s in steps] + [tp.galois_conj]:
        assert np.array_equal(jp.automorph_eval_perm(g),
                              tp.automorph_eval_perm(g))
        assert_same(jp.automorph_coeff_maps(g), tp.automorph_coeff_maps(g))


def test_numtheory_equal():
    assert jnt.gen_ntt_primes(1 << 12, 20) == numtheory.gen_ntt_primes(
        1 << 12, 20)
    for q in numtheory.gen_ntt_primes(1 << 10, 4):
        assert jnt.mont_constants(q) == numtheory.mont_constants(q)
        assert (jnt.find_primitive_2n_root(q, 1 << 10)
                == numtheory.find_primitive_2n_root(q, 1 << 10))
        assert jnt.modinv(12345, q) == numtheory.modinv(12345, q)


@pytest.mark.parametrize("shape", SHAPES)
def test_refimpl_keys_and_ciphertexts_equal(shape):
    """Same seed, same keys, ciphertexts and results: keygen, a rotation
    key, encode + encrypt, hmult, hrotate and decrypt, both on the numpy
    path (the native core's equality: tests/test_torch_native.py)."""
    jp, tp = jparams.get_params(*shape), params.get_params(*shape)
    jr = jrefimpl.RefCkks(jp, seed=5, use_native=False)
    tr = refimpl.RefCkks(tp, seed=5, use_native=False)
    assert tr._native is None
    jr.keygen()
    tr.keygen()
    assert np.array_equal(jr.s_eval, tr.s_eval)
    assert_same(jr.relin_key.digits, tr.relin_key.digits)
    assert_same(jr.gen_rotation_key(1).digits, tr.gen_rotation_key(1).digits)
    rng = np.random.default_rng(0)
    v = rng.normal(size=tp.n // 2)
    level = tp.max_level
    jc = jr.encrypt(jr.encode_complex(v, level, 2.0**29))
    tc = tr.encrypt(tr.encode_complex(v, level, 2.0**29))
    assert np.array_equal(jc.data, tc.data)
    assert np.array_equal(jr.hmult(jc, jc).data, tr.hmult(tc, tc).data)
    rot = tr.hrotate(tc, 1)
    assert np.array_equal(jr.hrotate(jc, 1).data, rot.data)
    assert np.array_equal(jr.decrypt_complex(rot), tr.decrypt_complex(rot))


def test_encoder_equal():
    rng = np.random.default_rng(1)
    v = rng.normal(size=64) + 1j * rng.normal(size=64)
    je, te = jencoder.CkksEncoder(128), encoder.CkksEncoder(128)
    coeffs = te.encode(v, 2.0**20)
    assert np.array_equal(je.encode(v, 2.0**20), coeffs)
    assert np.array_equal(je.decode(coeffs, 2.0**20),
                          te.decode(coeffs, 2.0**20))


@pytest.mark.parametrize("cfg", ["configs/tiny.cfg", "configs/n16.cfg"])
def test_config_equal(cfg):
    assert jconfig.parse_cfg(cfg) == config.parse_cfg(cfg)
    assert_same(jconfig.RunConfig.from_cli(cfg, "hrotate", 45, 35, 15),
                config.RunConfig.from_cli(cfg, "hrotate", 45, 35, 15))


def test_stats_equal():
    for op in ("hadd", "pmult", "hmult", "hsquare", "hrotate"):
        assert (jstats.op_modmul_count(op, 1 << 16, 35, 15, 3)
                == stats.op_modmul_count(op, 1 << 16, 35, 15, 3))
    s, js = stats.Statistic(), jstats.Statistic()
    for st in (s, js):
        st.increase("op/hmult")
        st.increase("op/hmult", 2)
        st.set("limbs", 35)
    assert s.table() == js.table()
    assert s.to_json() == js.to_json()
