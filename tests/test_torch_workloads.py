"""The port's encrypted workloads (homulator_tpu_torch.workloads) at the
smoke parameters of scripts/bench_workload.py and scripts/bench_logreg.py:
bit for bit (tolerance 0) against those programs' computation on a JAX
engine of the same seed, re-expressed here with the JAX package's own
graph functions (the programs keep it in closures inside main(), and the
JAX side is not edited); equal to their op-by-op composition through the
port's CkksEngine methods; within the programs' 1e-2 gate of the clear
result; and equal on the piecewise, the fused HPIP and the graph route."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu import params as jparams
from homulator_tpu.api import (
    CkksEngine as JaxEngine, _hrotate_graph, _hrotate_hoisted_graph,
    _hsquare_graph, hmult_graph as jax_hmult_graph,
)
from homulator_tpu.ops.modmath import modadd, mont_mul, to_mont
from homulator_tpu.ops.rescale import rescale_poly
from homulator_tpu_torch import api, linalg, workloads
from homulator_tpu_torch.api import CkksEngine, get_params
from homulator_tpu_torch.context import Ciphertext

# the smoke parameters of the JAX programs
MATVEC = dict(params=dict(n=256, max_level=8, alpha=4), level=6,
              scale=2.0**26, d=16, g=4, seed=7)
LOGREG = dict(params=dict(n=256, max_level=10, alpha=5), level=8,
              scale=2.0**29, b=0.3, seed=11)
GATE = 1e-2
ROUTES = ["pieces", "fused", "graph"]


def _qq(jeng, level):
    q, qinv, r2 = jeng.dc.q_level(level)
    return q[:, None, None], qinv[:, None, None], r2[:, None, None]


def jax_matvec(jeng, ct, M, level, scale, g):
    """scripts/bench_workload.py's matvec on a JAX engine, its giant-group
    scan unrolled (modular addition is exact, so the order gives the same
    bits)."""
    p, dc = jeng.params, jeng.dc
    d, slots = M.shape[0], p.n // 2
    baby_steps = list(range(1, g))
    giant_steps = [g * j for j in range(1, d // g)]
    for s in baby_steps + giant_steps:
        jeng.gen_rotation_key(s)
    kt = dc.keyswitch_tables(level)
    pts = []
    for j in range(d // g):
        for i in range(g):
            k = g * j + i
            diag_k = np.array([M[t % d, (t + k) % d] for t in range(d)])
            pdiag = np.tile(np.roll(diag_k, g * j), slots // d)
            pts.append(jeng.plaintext_complex(pdiag, level, scale).data)
    q3, qi3, r23 = _qq(jeng, level)
    pt_mont = to_mont(jnp.stack(pts), r23[None], q3[None], qi3[None])
    ptg = pt_mont.reshape(d // g, g, *pt_mont.shape[1:])

    def group_sum(pm_j, baby_stack):
        t = mont_mul(baby_stack, pm_j[:, None], q3[None, None],
                     qi3[None, None])
        while t.shape[0] > 1:
            h = t.shape[0] // 2
            t = modadd(t[:h], t[h:], q3[None, None])
        return t[0]

    def perm(s):
        return dc.automorph_perm(p.galois_elt(s))

    rots = _hrotate_hoisted_graph(ct, tuple(perm(s) for s in baby_steps),
                                  tuple(jeng.rot_keys[s] for s in baby_steps),
                                  kt)
    baby_stack = jnp.concatenate([ct[None], rots], axis=0)
    acc = group_sum(ptg[0], baby_stack)
    for j, s in enumerate(giant_steps, start=1):
        acc = modadd(acc, _hrotate_graph(group_sum(ptg[j], baby_stack),
                                         perm(s), jeng.rot_keys[s], kt),
                     q3[None])
    return acc


def jax_logreg(jeng, ct, w, b, level, scale):
    """scripts/bench_logreg.py's logreg on a JAX engine, its rotation scan
    unrolled; returns the [2, level-3] output."""
    p, dc = jeng.params, jeng.dc
    slots = p.n // 2
    steps = [1 << i for i in range(slots.bit_length() - 1)]
    pt_w = jeng.plaintext_complex(w, level, scale)
    for s in steps:
        jeng.gen_rotation_key(s)

    def lvl(levl):
        return (dc.keyswitch_tables(levl), dc.ntt_basis((levl - 1,)),
                dc.ntt_basis(dc.main_rows(levl - 1)),
                dc.rescale_qinv_mont(levl))

    L2, L3, L4 = level - 1, level - 2, level - 3
    kt1, last1, out1, rs1 = lvl(level)
    T2, T3 = lvl(L2), lvl(L3)
    delta, delta_adj, s_out = workloads.logreg_scales(p, level, scale)

    def const_mont(value, levl, mult):
        c = int(round(value * mult))
        qs_ = p.q_arr[:levl].astype(np.int64)
        res = (np.int64(c) % qs_).astype(np.uint64)
        cm = ((res << np.uint64(32)) % qs_.astype(np.uint64)).astype(
            np.uint32)
        return jnp.asarray(cm)[:, None, None]

    c_lin = const_mont(0.197, L2, delta_adj)
    c_cub = const_mont(-0.004, L4, delta)
    pt_b = jeng.plaintext_ints(
        np.concatenate([[int(round(b * scale * scale))],
                        np.zeros(p.n - 1, dtype=np.int64)]), level,
        scale * scale)
    half_pt = jeng.plaintext_ints(
        np.concatenate([[int(round(0.5 * s_out))],
                        np.zeros(p.n - 1, dtype=np.int64)]), L4, s_out)
    q1, qi1, r21 = _qq(jeng, level)
    q2, qi2, _ = _qq(jeng, L2)
    q4, qi4, _ = _qq(jeng, L4)
    evk = jeng.relin_key

    ptm = to_mont(pt_w.data, r21, q1, qi1)
    acc = jnp.stack([mont_mul(ct[0], ptm, q1, qi1),
                     mont_mul(ct[1], ptm, q1, qi1)])
    for s in steps:
        rot = _hrotate_graph(acc, dc.automorph_perm(p.galois_elt(s)),
                             jeng.rot_keys[s], kt1)
        acc = modadd(acc, rot, q1[None])
    acc = acc.at[0].set(modadd(acc[0], pt_b.data, q1))
    t = jnp.stack([rescale_poly(acc[k], last1, out1, rs1) for k in (0, 1)])
    t2 = _hsquare_graph(t, evk, *T2)
    t3 = jax_hmult_graph(t[:, :L3], t2, evk, *T3)
    lin = jnp.stack([mont_mul(t[k], c_lin, q2, qi2) for k in (0, 1)])
    cub = jnp.stack([mont_mul(t3[k], c_cub, q4, qi4) for k in (0, 1)])
    y = modadd(lin[:, :L4], cub, q4[None])
    return y.at[0].set(modadd(y[0], half_pt.data, q4))


def _engines(params, seed):
    """The port's CPU engine on the accelerated route and a graph-route
    engine sharing its host engine and keys."""
    eng = CkksEngine(params, seed=seed, device="cpu")
    eng.keygen()
    geng = CkksEngine(params, seed=seed, device="cpu", ntt_mode="jnp")
    geng.ref, geng.relin_key, geng.rot_keys = eng.ref, eng.relin_key, \
        eng.rot_keys
    return eng, geng


def _as_int32(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


@pytest.fixture(scope="module")
def matvec():
    c = MATVEC
    jeng = JaxEngine(jparams.get_params(**c["params"]), seed=c["seed"])
    jeng.keygen()
    eng, geng = _engines(get_params(**c["params"]), c["seed"])
    d, slots = c["d"], eng.params.n // 2
    rng = np.random.default_rng(c["seed"])
    M = rng.normal(size=(d, d)) / d
    x = rng.normal(size=d)
    x_slots = np.tile(x, slots // d)
    jct = jeng.encrypt_complex(x_slots, c["level"], c["scale"])
    ct = eng.encrypt_complex(x_slots, c["level"], c["scale"])
    assert np.array_equal(_as_int32(jct.data), ct.data.numpy())
    want = _as_int32(jax_matvec(jeng, jct.data, M, c["level"], c["scale"],
                                c["g"]))
    preps = {"pieces": workloads.matvec_prep(eng, M, c["level"], c["scale"],
                                             c["g"])}
    preps["fused"] = preps["pieces"]
    preps["graph"] = workloads.matvec_prep(geng, M, c["level"], c["scale"],
                                           c["g"])
    return SimpleNamespace(eng=eng, ct=ct, M=M, x=x, want=want, preps=preps)


@pytest.fixture(scope="module")
def logreg():
    c = LOGREG
    jeng = JaxEngine(jparams.get_params(**c["params"]), seed=c["seed"])
    jeng.keygen()
    eng, geng = _engines(get_params(**c["params"]), c["seed"])
    slots = eng.params.n // 2
    rng = np.random.default_rng(c["seed"])
    x = rng.normal(size=slots)
    w = rng.normal(size=slots) / np.sqrt(slots)
    jct = jeng.encrypt_complex(x, c["level"], c["scale"])
    ct = eng.encrypt_complex(x, c["level"], c["scale"])
    assert np.array_equal(_as_int32(jct.data), ct.data.numpy())
    want = _as_int32(jax_logreg(jeng, jct.data, w, c["b"], c["level"],
                                c["scale"]))
    args = (w, c["b"], c["level"], c["scale"])
    preps = {"pieces": workloads.logreg_prep(eng, *args)}
    preps["fused"] = preps["pieces"]
    preps["graph"] = workloads.logreg_prep(geng, *args)
    return SimpleNamespace(eng=eng, ct=ct, x=x, w=w, want=want, preps=preps)


@pytest.mark.parametrize("route", ROUTES)
def test_matvec_matches_jax(matvec, route, monkeypatch):
    monkeypatch.setattr(api, "USE_FUSED_HPIP", route == "fused")
    got = workloads.matvec_bsgs(matvec.ct.data, matvec.preps[route])
    assert np.array_equal(got.numpy(), matvec.want)


def test_matvec_matches_engine_ops(matvec):
    """linalg.bsgs_matvec: hrotate_hoisted, pmult, hadd and hrotate, one
    engine call each."""
    got = workloads.matvec_bsgs(matvec.ct.data, matvec.preps["pieces"])
    ops = linalg.bsgs_matvec(matvec.eng, matvec.ct, matvec.M,
                             g=MATVEC["g"], rescale_out=False)
    assert torch.equal(got, ops.data)


def test_matvec_decrypts(matvec):
    prep = matvec.preps["pieces"]
    got = workloads.matvec_bsgs(matvec.ct.data, prep)
    y = matvec.eng.decrypt_complex(Ciphertext(
        got, prep.level, prep.out_scale)).real[:prep.d]
    assert np.max(np.abs(y - matvec.M @ matvec.x)) < GATE


@pytest.mark.parametrize("route", ROUTES)
def test_logreg_matches_jax(logreg, route, monkeypatch):
    monkeypatch.setattr(api, "USE_FUSED_HPIP", route == "fused")
    got = workloads.logreg_sigmoid3(logreg.ct.data, logreg.preps[route])
    assert np.array_equal(got.numpy(), logreg.want)


def test_logreg_matches_engine_ops(logreg):
    """pmult, hrotate + hadd, padd, rescale, hsquare, mod_drop, hmult, a
    pmult by each constant's plaintext (whose eval form is the constant in
    every word), align_levels, hadd and padd: one engine call each."""
    eng, prep = logreg.eng, logreg.preps["pieces"]
    p, level, scale = eng.params, prep.level, prep.scale
    delta, delta_adj, s_out = workloads.logreg_scales(p, level, scale)

    def constant(value, levl, s):
        m = np.zeros(p.n, dtype=np.int64)
        m[0] = int(round(value * s))
        return eng.plaintext_ints(m, levl, s)

    acc = eng.pmult(logreg.ct, eng.plaintext_complex(logreg.w, level, scale))
    step = 1
    while step < p.n // 2:
        acc = eng.hadd(acc, eng.hrotate(acc, step))
        step <<= 1
    t = eng.rescale(eng.padd(acc, constant(LOGREG["b"], level, acc.scale)))
    t2 = eng.hsquare(t)
    t3 = eng.hmult(eng.mod_drop(t, 1), t2)
    lin = eng.pmult(t, constant(0.197, t.level, delta_adj))
    cub = eng.pmult(t3, constant(-0.004, t3.level, delta))
    lin, cub = eng.align_levels(lin, cub)
    y = eng.padd(eng.hadd(lin, cub), constant(0.5, cub.level, s_out))
    got = workloads.logreg_sigmoid3(logreg.ct.data, prep)
    assert y.level == prep.out_level
    assert torch.equal(got, y.data)


def test_logreg_decrypts(logreg):
    prep = logreg.preps["pieces"]
    got = workloads.logreg_sigmoid3(logreg.ct.data, prep)
    y = logreg.eng.decrypt_complex(Ciphertext(
        got, prep.out_level, prep.s_out))[0].real
    score = float(np.dot(logreg.x, logreg.w) + LOGREG["b"])
    c0, c1, c3 = workloads.SIGMOID3
    assert abs(y - (c0 + c1 * score + c3 * score**3)) < GATE

