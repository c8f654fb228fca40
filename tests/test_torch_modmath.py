"""Port modmath (int64 carriers) vs homulator_tpu.ops.modmath (uint32):
every reduced output equal (tolerance 0: the outputs are exact residues)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu import numtheory as nt
from homulator_tpu.ops import modmath as jm
from homulator_tpu_torch.ops import modmath as tm

# primes just below PRIME_CAP (~2^29.4) and just below 2^29
_Q = np.array(nt.gen_ntt_primes(64, 4) + nt.gen_ntt_primes(64, 4, 29),
              dtype=np.uint64)
_MONT = [nt.mont_constants(int(q)) for q in _Q]
_QINV = np.array([m[0] for m in _MONT], dtype=np.uint64)
_R2 = np.array([m[1] for m in _MONT], dtype=np.uint64)


def _j(x):
    return jnp.asarray(np.asarray(x, dtype=np.uint64).astype(np.uint32))


def _t(x):
    u = np.ascontiguousarray(np.asarray(x, dtype=np.uint64).astype(np.uint32))
    return torch.from_numpy(u.view(np.int32))


def _same(jx, tx):
    return np.array_equal(np.asarray(jx).astype(np.int64), tx.numpy())


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    q = _Q[:, None]
    a = rng.integers(0, q, size=(len(_Q), 513), dtype=np.uint64)
    b = rng.integers(0, q, size=(len(_Q), 513), dtype=np.uint64)
    a[:, :3] = [0, 1, 2]  # edges: 0, 1 and q-1
    a[:, 3] = _Q - 1
    b[:, 4] = _Q - 1
    return a, b, q


def _case(name, a, b, q):
    """(jax result, port result) of one op on the same operands."""
    qi, r2 = _QINV[:, None], _R2[:, None]
    tq = torch.from_numpy(q.astype(np.int64))
    if name == "modadd":
        return jm.modadd(_j(a), _j(b), _j(q)), tm.modadd(_t(a), _t(b), tq)
    if name == "modsub":
        return jm.modsub(_j(a), _j(b), _j(q)), tm.modsub(_t(a), _t(b), tq)
    if name == "cond_sub":
        s = a + b  # [0, 2q)
        return jm.cond_sub(_j(s), _j(q)), tm.cond_sub(_t(s), tq)
    if name == "mont_mul":
        return (jm.mont_mul(_j(a), _j(b), _j(q), _j(qi)),
                tm.mont_mul(_t(a), _t(b), tq, _t(qi)))
    if name == "mulmod":  # the JAX form of a data x data product
        bm = jm.to_mont(_j(b), _j(r2), _j(q), _j(qi))
        return jm.mont_mul(_j(a), bm, _j(q), _j(qi)), tm.mulmod(_t(a), _t(b), tq)
    if name == "shoup_mul":
        w_sh = (b << np.uint64(32)) // q
        return (jm.shoup_mul(_j(a), _j(b), _j(w_sh), _j(q)),
                tm.shoup_mul(_t(a), _t(b), _t(w_sh), tq))
    if name == "lazy_sum_reduce":  # terms in [0, 2q) from the lazy product
        terms = [jm.mont_mul_lazy(_j(a), _j(np.roll(b, k, axis=1)), _j(q),
                                  _j(qi)) for k in range(7)]
        return (jm.lazy_sum_reduce(terms, _j(q)),
                tm.lazy_sum_reduce([_t(np.asarray(t)) for t in terms], tq))
    if name == "lazy_tree_sum":
        terms = np.stack([np.asarray(jm.mont_mul_lazy(
            _j(a), _j(np.roll(b, k, axis=1)), _j(q), _j(qi)))
            for k in range(5)])
        return (jm.lazy_tree_sum(jnp.asarray(terms), _j(q)),
                tm.lazy_tree_sum(_t(terms), tq))
    raise ValueError(name)


@pytest.mark.parametrize("name", [
    "modadd", "modsub", "cond_sub", "mont_mul", "mulmod",
    "shoup_mul", "lazy_sum_reduce", "lazy_tree_sum",
])
def test_port_op_matches_jax(name, data):
    a, b, q = data
    jx, tx = _case(name, a, b, q)
    assert tx.dtype == torch.int64
    assert _same(jx, tx), name
    assert int(tx.min()) >= 0 and bool((tx < torch.from_numpy(
        q.astype(np.int64))).all())


def test_mulmod_is_exact_product(data):
    """The plain-version primitive against exact integer arithmetic."""
    a, b, q = data
    got = tm.mulmod(_t(a), _t(b), torch.from_numpy(q.astype(np.int64)))
    want = (a.astype(object) * b.astype(object)) % q.astype(object)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
