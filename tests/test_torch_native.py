"""The port's binding of the native host core (homulator_tpu_torch.native)
against the numpy reference, bit for bit, as tests/test_native.py holds
the JAX package's: the NTT both ways, the elementwise ops and the base
conversion against the JAX numpy reference; the port's
RefCkks(use_native=True) against the JAX RefCkks(use_native=False) of the
same seed (keys, encodes, ciphertexts, hmult, hrotate); the meaning of
use_native (None never builds, True builds or raises). The library is
built into a directory of this module's own, so every other test keeps
the numpy path."""

import numpy as np
import pytest

from homulator_tpu import params as jparams
from homulator_tpu.refimpl import RefCkks as JaxRefCkks
from homulator_tpu_torch import native, params
from homulator_tpu_torch.refimpl import RefCkks

from .conftest import random_limbs

SHAPES = [(64, 6, 2), (128, 5, 3)]


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    """native.BUILD_DIR pointed at a fresh directory holding the built
    library for this module's tests."""
    path = str(tmp_path_factory.mktemp("native"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "BUILD_DIR", path)
        native.load()
        yield path


@pytest.fixture
def lib(build_dir):
    return native.load()


@pytest.mark.parametrize("shape", SHAPES)
def test_native_ntt_matches_numpy(lib, shape):
    jp = jparams.get_params(*shape)
    tp = params.get_params(*shape)
    ref = JaxRefCkks(jp, seed=0, use_native=False)
    nn = native.NativeNtt(tp, lib)
    rng = np.random.default_rng(0)
    idx = np.arange(tp.num_primes)
    x = random_limbs(tp, idx, rng)
    y = nn.ntt(x, idx)
    assert np.array_equal(y, ref.ntt(x, idx))
    assert np.array_equal(nn.intt(y, idx), ref.intt(y, idx))
    assert np.array_equal(nn.intt(y, idx), x)
    sub = np.array([2, 0, tp.num_primes - 1])  # rows out of order
    assert np.array_equal(nn.ntt(x[sub], sub), ref.ntt(x[sub], sub))


def test_native_ntt_rejects_shape(lib):
    tp = params.get_params(64, 6, 2)
    nn = native.NativeNtt(tp, lib)
    with pytest.raises(ValueError, match="native NTT"):
        nn.ntt(np.zeros((2, tp.n), dtype=np.uint64), np.arange(3))


def test_native_ewe_ops(lib, small_params):
    rng = np.random.default_rng(1)
    idx = np.arange(4)
    a = random_limbs(small_params, idx, rng)
    b = random_limbs(small_params, idx, rng)
    qs = np.ascontiguousarray(small_params.q_arr[idx])
    M, N = a.shape
    out = np.zeros_like(a)
    lib.ckks_ewe_mul(a, b, out, M, N, qs)
    assert np.array_equal(out, (a * b) % qs[:, None])
    lib.ckks_ewe_add(a, b, out, M, N, qs)
    assert np.array_equal(out, (a + b) % qs[:, None])
    lib.ckks_ewe_sub(a, b, out, M, N, qs)
    assert np.array_equal(out, (a + qs[:, None] - b) % qs[:, None])
    assert lib.ckks_core_version() == 1


def test_native_bconv(lib, small_params):
    rng = np.random.default_rng(2)
    nd, Mout = 3, 5
    xhat = random_limbs(small_params, np.arange(nd), rng)
    out_qs = np.ascontiguousarray(small_params.q_arr[nd: nd + Mout])
    mat = rng.integers(0, 1 << 30, size=(Mout, nd)).astype(np.uint64)
    out = np.zeros((Mout, small_params.n), dtype=np.uint64)
    lib.ckks_bconv(np.ascontiguousarray(xhat), np.ascontiguousarray(mat), out,
                   nd, Mout, small_params.n, out_qs)
    for j in range(Mout):
        q = out_qs[j]
        acc = np.zeros(small_params.n, dtype=np.uint64)
        for i in range(nd):
            acc = (acc + xhat[i] * (mat[j, i] % q)) % q
        assert np.array_equal(out[j], acc)


@pytest.mark.parametrize("shape", SHAPES)
def test_refimpl_native_matches_jax_numpy(build_dir, shape):
    """Keys, encodes, ciphertexts and results of the port's host engine on
    the native core equal the JAX host engine's on numpy."""
    jr = JaxRefCkks(jparams.get_params(*shape), seed=3, use_native=False)
    tr = RefCkks(params.get_params(*shape), seed=3, use_native=True)
    assert tr._native is not None
    jr.keygen()
    tr.keygen()
    assert np.array_equal(jr.s_eval, tr.s_eval)
    for jd, td in zip(jr.relin_key.digits, tr.relin_key.digits):
        assert np.array_equal(jd, td)
    for jd, td in zip(jr.gen_rotation_key(1).digits,
                      tr.gen_rotation_key(1).digits):
        assert np.array_equal(jd, td)
    n, level = tr.p.n, tr.p.max_level
    v = np.random.default_rng(4).normal(size=n // 2)
    jpt = jr.encode_complex(v, level, 2.0**29)
    tpt = tr.encode_complex(v, level, 2.0**29)
    assert np.array_equal(jpt.data, tpt.data)
    m = np.zeros(n, dtype=np.int64)
    m[0] = int(5 * 2.0**29)
    assert np.array_equal(jr.encode_ints(m, level, 2.0**29).data,
                          tr.encode_ints(m, level, 2.0**29).data)
    jc, tc = jr.encrypt(jpt), tr.encrypt(tpt)
    assert np.array_equal(jc.data, tc.data)
    assert np.array_equal(jr.hmult(jc, jc).data, tr.hmult(tc, tc).data)
    assert np.array_equal(jr.hrotate(jc, 1).data, tr.hrotate(tc, 1).data)
    assert np.array_equal(jr.decrypt_complex(jc), tr.decrypt_complex(tc))


def test_use_native_none_never_builds(tmp_path, monkeypatch):
    """None takes the library only where it is already built; False never
    takes it."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    tp = params.get_params(64, 6, 2)
    assert RefCkks(tp, seed=0)._native is None
    assert not list(tmp_path.iterdir())
    native.load()
    assert RefCkks(tp, seed=0)._native is not None
    assert RefCkks(tp, seed=0, use_native=False)._native is None


def test_use_native_raises_without_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        RefCkks(params.get_params(64, 6, 2), seed=0, use_native=True)


def test_use_native_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXXFLAGS",
                        native.CXXFLAGS + ["-no-such-flag"])
    with pytest.raises(RuntimeError, match="no-such-flag"):
        RefCkks(params.get_params(64, 6, 2), seed=0, use_native=True)
    assert not [p for p in tmp_path.iterdir() if p.suffix == ".so"]
