"""The reference's five parameter-set structures on the port, CPU plain
path, bit for bit (tolerance 0) against the JAX package, at small N:

  set A / M  (maxLevel 28, alpha 28): dnum 1 at every level, n = 128
  set B      (45, 15): three digits, the last partial at most levels
  set C      (24, 6): dnum 4
  set D      (26, 9): a partial last digit

(scripts/sweep.py's PARAM_SETS at n = 128 or 256 in place of 2^15 or
2^16; the limb structure, which decides every kernel's shape but the
ring's, is the sets' own.) At each set's max level and at level 2: hmult
and hrotate(1) against the JAX package's exact engine (its
`refimpl.RefCkks`, which its own tests hold its engine to: compiling the
JAX engine's key switch at 45-60 limbs takes tens of seconds a shape on
the CPU), and hadd, pmult and padd against the JAX engine. Then set A's
widest conversions, on the context's tables at level 28: the tail (nd =
alpha + 3 = 31, the largest count of k32 steps that kernel B3 has) and
ModUp digit 0 (28 + 1 rows), each against the JAX bconv_fused in
interpret mode and against an int64 model of B3's tensor-core schedule
(tests/test_torch_bconv_mma.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu.api import CkksEngine as JaxEngine
from homulator_tpu.context import DeviceContext as JaxContext
from homulator_tpu.ops.bconv_fused import bconv_fused as jax_bconv
from homulator_tpu.params import get_params as jax_get_params
from homulator_tpu_torch.api import CkksEngine, get_params
from homulator_tpu_torch.ops.bconv_fused import bconv_fused
from tests.test_torch_bconv_mma import _b3

SCALE = 2.0**29
SETS = {"A": (128, 28, 28), "B": (256, 45, 15), "C": (256, 24, 6),
        "D": (256, 26, 9)}  # (n, maxLevel, alpha)
OPS = ("hmult", "hrotate", "hadd", "pmult", "padd")


@pytest.fixture(scope="module", params=list(SETS))
def engines(request):
    """(set name, JAX engine, port engine on the CPU), same seed and key
    order, so their keys are equal; both hold the rotation key of step 1."""
    n, L, a = SETS[request.param]
    jeng = JaxEngine(jax_get_params(n=n, max_level=L, alpha=a), seed=3,
                     ntt_mode="jnp")
    eng = CkksEngine(get_params(n=n, max_level=L, alpha=a), seed=3,
                     device="cpu")
    for e in (jeng, eng):
        e.keygen()
        e.gen_rotation_key(1)
    return request.param, jeng, eng


def _u64(t):
    return np.asarray(t).view(np.uint32).astype(np.uint64)


@pytest.mark.parametrize("at", ["max", "2"])
@pytest.mark.parametrize("op", OPS)
def test_op_matches_jax(engines, op, at):
    name, jeng, eng = engines
    p = eng.params
    level = p.max_level if at == "max" else 2
    assert p.beta(p.max_level) == {"A": 1, "B": 3, "C": 4, "D": 3}[name]
    rng = np.random.default_rng(level + len(op))
    half = p.n // 2
    r1, r2 = (eng.ref.encrypt(eng.ref.encode_complex(rng.normal(size=half),
                                                     level, SCALE))
              for _ in range(2))
    pt = eng.ref.encode_complex(rng.normal(size=half), level, SCALE)
    a, b = (eng.dc.upload_ct(r.data, level, SCALE) for r in (r1, r2))
    ja, jb = (jeng.dc.upload_ct(r.data, level, SCALE) for r in (r1, r2))
    tpt = eng.dc.upload_pt(pt.data, level, SCALE)
    jpt = jeng.dc.upload_pt(pt.data, level, SCALE)
    if op == "hmult":
        got, want = eng.hmult(a, b), jeng.ref.hmult(r1, r2).data
    elif op == "hrotate":
        got, want = eng.hrotate(a, 1), jeng.ref.hrotate(r1, 1).data
    elif op == "hadd":
        got, want = eng.hadd(a, b), jeng.dc.download(jeng.hadd(ja, jb).data)
    elif op == "pmult":
        got, want = eng.pmult(a, tpt), jeng.dc.download(
            jeng.pmult(ja, jpt).data)
    else:
        got, want = eng.padd(a, tpt), jeng.dc.download(
            jeng.padd(ja, jpt).data)
    assert got.level == level - int(op == "hmult")
    assert np.array_equal(eng.dc.download(got.data), want)


@pytest.fixture(scope="module")
def set_a_tables():
    n, L, a = SETS["A"]
    jp = jax_get_params(n=n, max_level=L, alpha=a)
    eng = CkksEngine(get_params(n=n, max_level=L, alpha=a), device="cpu")
    return (eng.params, JaxContext(jp, ntt_mode="interpret")
            .keyswitch_tables(L), eng.dc.keyswitch_tables(L))


@pytest.mark.parametrize("which", ["tail", "modup0"])
def test_set_a_widest_conversions(set_a_tables, which):
    p, jkt, kt = set_a_tables
    if which == "tail":
        jt, tt = jkt.tail, kt.tail
        tabs = (tt.one, tt.one_sh, tt.in_q, tt.mat, tt.bf16, tt.horner_sh,
                tt.out_nt.q)
        mma, center = tt.mma, False
        jargs = (jt.one_pl, jt.one_sh, jt.in_q, jt.bf16, jt.horner_sh,
                 jt.out_nt.q)
        assert tt.in_q.shape[0] == p.alpha + 3 == 31
    else:
        jd, dt = jkt.digits[0], kt.digits[0]
        tabs = (dt.step1, dt.step1_sh, dt.in_q, dt.mat, dt.mat_bf16,
                dt.horner_sh, dt.other_nt.q)
        mma, center = dt.mat_mma, True
        jargs = (jd.step1_pl, jd.step1_sh, jkt.main_nt.q[dt.lo:dt.hi],
                 jd.mat_bf16, jd.horner_sh, jd.other_nt.q)
        assert dt.in_q.shape[0] + 1 == p.max_level + 1 == 29
    in_q = _u64(tabs[2].numpy())
    rng = np.random.default_rng(31)
    t = p.ntt
    x = rng.integers(0, in_q[:, None, None], size=(len(in_q), t.n1, t.n2),
                     dtype=np.uint64)
    x[:, 0] = in_q[:, None] - 1  # the worst case on one row of the tile
    got = bconv_fused(torch.from_numpy(x.astype(np.uint32).view(np.int32)),
                      *tabs[:4], mma, tabs[5], tabs[6], center=center)
    want = np.asarray(jax_bconv(jnp.asarray(x.astype(np.uint32)), *jargs,
                                interpret=True, center=center))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    model, plain = _b3(x.reshape(len(in_q), -1), tabs, center,
                       np.random.default_rng(7))
    np.testing.assert_array_equal(model, plain)
    np.testing.assert_array_equal(
        model, want.reshape(want.shape[0], -1).astype(np.uint64))
