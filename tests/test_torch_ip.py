"""Kernel B18, the piecewise route's key-switch inner product
(`ops/ip.py`, `ops/keyswitch.py::inner_product_pieces`), bit for bit
(tolerance 0):

  * ip_plain equals the int64 route it replaced (the torch ops that
    inner_product_pieces ran before, below as `_int64_route`), cast to
    int32, and the graph route's `inner_product` on the assembled digits:
    with and without a batch, 3 and 4 digits, a last digit shorter than
    alpha, random and all-(q - 1) inputs;
  * the route makes one B18 call a key switch: hmult_graph on a batch,
    hsquare_graph, hrotate_graph, one a rotation in hrotate_hoisted_graph,
    14 in a 64 x 64 BSGS matvec at g = 8, none on the fused and graph
    routes (on the CPU the wrapper runs ip_plain where the card launches
    the kernel and counts kernels.LAUNCHES["ip"]; the card test checks
    that count);
  * ip_kernel refuses CPU tensors, a wrong dtype, wrong piece shapes and
    too many digits;
  * the engine's hmult, hsquare, hrotate and hrotate_hoisted equal the
    exact host engine (RefCkks).

Imports no JAX: the `card` test runs on a CUDA GPU with
`python -m pytest --noconftest -m card tests/test_torch_ip.py` (the
conftest imports JAX) and skips here.
"""

import numpy as np
import pytest
import torch

from homulator_tpu_torch import api, kernels, workloads
from homulator_tpu_torch.api import CkksEngine, get_params
from homulator_tpu_torch.context import Ciphertext, DeviceContext
from homulator_tpu_torch.ops import keyswitch as ks
from homulator_tpu_torch.ops.automorph import automorph_eval
from homulator_tpu_torch.ops.ip import ip_kernel, ip_plain
from homulator_tpu_torch.ops.modmath import col, lazy_sum_reduce, mont_mul

SCALE = 2.0 ** 26
# (n, maxLevel, alpha, level): three digits, three with a last digit of
# one row (alpha 2), four with a last digit of one row
SHAPES = {"3 digits": (64, 6, 2, 6), "3 digits, last short": (64, 6, 2, 5),
          "4 digits, last short": (64, 8, 2, 7)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: kernel B18 runs only on the card")


def _int64_route(convs, d_eval, key, kt):
    """inner_product_pieces before kernel B18: torch's int64 ops on the
    assembled digits; per k the pair (acc_sp, acc_main), int64."""
    alpha = kt.special_nt.q.shape[0]
    k_ext = alpha + kt.level
    q, qinv = col(kt.ext_nt.q), col(kt.ext_qinv)
    exts = []
    for conv, dt in zip(convs, kt.digits):
        cut = alpha + dt.lo
        exts.append(torch.cat([conv[..., :cut, :, :],
                               d_eval[..., dt.lo:dt.hi, :, :],
                               conv[..., cut:, :, :]], dim=-3))
    out = []
    for k in (0, 1):
        acc = lazy_sum_reduce(
            [mont_mul(e, key[d, k, :k_ext], q, qinv)
             for d, e in enumerate(exts)], q)
        out.append((acc[..., :alpha, :, :], acc[..., alpha:, :, :]))
    return out


def _inputs(dc, level, batch, worst, seed, device="cpu"):
    """Random (or all q - 1) eval-domain pieces, own rows and Montgomery
    key words at dc's `level`: (convs, d_eval, key, kt); with a batch,
    pieces [B, rows_d, n2, n1] and d_eval [B, level, n2, n1]."""
    p = dc.params
    n1, n2 = p.ntt.n1, p.ntt.n2
    kt = dc.keyswitch_tables(level)
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)

    def make(q, shape):
        q = np.asarray(q.cpu() if isinstance(q, torch.Tensor) else q,
                       dtype=np.int64).reshape((-1, 1, 1))
        x = (np.broadcast_to(q - 1, shape) if worst
             else rng.integers(0, q, size=shape))
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(
            device)

    key_q = np.concatenate([p.q_arr[p.max_level:], p.q_arr[:p.max_level]])
    key = make(np.tile(key_q, 2 * p.dnum),
               (2 * p.dnum * p.num_primes, n2, n1)).view(
                   p.dnum, 2, p.num_primes, n2, n1)
    convs = [make(dt.other_nt.q, lead + (dt.other_nt.q.shape[0], n2, n1))
             for dt in kt.digits]
    return convs, make(kt.main_nt.q, lead + (level, n2, n1)), key, kt


@pytest.mark.parametrize("worst", [False, True], ids=["random", "q-1"])
@pytest.mark.parametrize("batch", [None, 3], ids=["one", "batch 3"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_equals_the_int64_route(shape, batch, worst):
    n, max_level, alpha, level = SHAPES[shape]
    dc = DeviceContext(get_params(n, max_level, alpha), "cpu")
    convs, d_eval, key, kt = _inputs(dc, level, batch, worst, level)
    assert len(kt.digits) == (4 if "4" in shape else 3)
    want = _int64_route(convs, d_eval, key, kt)
    got = ip_plain(convs, d_eval, key, kt)
    K = alpha + level
    lead = () if batch is None else (batch,)
    assert got.shape == lead + (2, K) + d_eval.shape[-2:]
    assert got.dtype == torch.int32
    for k in (0, 1):
        assert torch.equal(got[..., k, :, :, :],
                           torch.cat(want[k], dim=-3).to(torch.int32))
    pieces = ks.inner_product_pieces(convs, d_eval, key, kt)
    for k in (0, 1):
        for part, ref in zip(pieces[k], want[k]):
            assert part.dtype == torch.int32
            assert torch.equal(part, ref.to(torch.int32))
    # the graph route's inner_product on the assembled digits, element by
    # element
    for i in range(batch or 1):
        sel = (lambda t: t) if batch is None else (lambda t: t[i])
        exts = [torch.cat([sel(c)[:alpha + dt.lo],
                           sel(d_eval)[dt.lo:dt.hi],
                           sel(c)[alpha + dt.lo:]])
                for c, dt in zip(convs, kt.digits)]
        for k, acc in enumerate(ks.inner_product(exts, key, kt)):
            assert torch.equal(sel(got)[k], acc.to(torch.int32))


@pytest.fixture(scope="module")
def eng():
    """n = 256 (128 slots, room for the 64 x 64 matvec), maxLevel 8, alpha
    4, on the CPU, with the relinearisation key."""
    e = CkksEngine(get_params(256, 8, 4, 26), 7, device="cpu")
    e.keygen()
    return e


@pytest.fixture(scope="module")
def cts(eng):
    rng = np.random.default_rng(3)
    return [eng.encrypt_complex(rng.normal(size=128), 6, SCALE)
            for _ in range(4)]


def _ip_calls(fn):
    """fn()'s calls of B18: on the CPU, inner_product_pieces' runs of
    ip_plain, one where the card launches the kernel once."""
    calls = []
    real = ks.ip_plain

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ks, "ip_plain", spy)
        fn()
    return len(calls)


def _runs(eng, cts):
    """op -> (run, key switches it makes)."""
    kt = eng.dc.keyswitch_tables(6)
    ab = torch.stack([cts[0].data, cts[1].data])
    bb = torch.stack([cts[2].data, cts[3].data])
    perms = [eng.dc.automorph_perm(eng.params.galois_elt(s))
             for s in (1, 2, 3)]
    for s in (1, 2, 3):
        if s not in eng.rot_keys:
            eng.gen_rotation_key(s)
    keys = [eng.rot_keys[s] for s in (1, 2, 3)]
    return {
        "hmult_graph batch 2": (
            lambda: api.hmult_graph(ab, bb, eng.relin_key, kt), 1),
        "hsquare_graph": (
            lambda: api.hsquare_graph(cts[0].data, eng.relin_key, kt), 1),
        "hrotate_graph": (
            lambda: api.hrotate_graph(cts[0].data, perms[0], keys[0], kt), 1),
        "hrotate_hoisted_graph x3": (
            lambda: api.hrotate_hoisted_graph(cts[0].data, perms, keys, kt),
            3),
    }


@pytest.mark.parametrize("op,route", [
    (op, route) for op in ("hmult_graph batch 2", "hsquare_graph",
                           "hrotate_graph", "hrotate_hoisted_graph x3")
    for route in ("piecewise", "fused", "graph")
    if not (route == "graph" and op.startswith("hmult"))])
def test_one_call_a_key_switch(eng, cts, op, route, monkeypatch):
    """One B18 call a key switch on the piecewise route; the fused route
    takes B4 instead (but its hoisted rotations stay piecewise, as in the
    JAX package); the graph route (one ciphertext a call) never calls
    it."""
    monkeypatch.setattr(api, "USE_FUSED_HPIP", route == "fused")
    e = eng
    if route == "graph":
        e = CkksEngine(eng.params, 7, device="cpu", ntt_mode="jnp")
        e.ref, e.relin_key, e.rot_keys = eng.ref, eng.relin_key, eng.rot_keys
    run, switches = _runs(e, cts)[op]
    want = {"piecewise": switches, "graph": 0,
            "fused": switches if "hoisted" in op else 0}[route]
    assert _ip_calls(run) == want


def test_matvec_makes_fourteen_calls(eng):
    """A 64 x 64 BSGS matvec at g = 8: 7 hoisted baby rotations and 7
    giant ones, one B18 call each."""
    M = np.random.default_rng(4).normal(size=(64, 64)) / 64
    prep = workloads.matvec_prep(eng, M, 6, SCALE, 8)
    assert prep.keyswitches == 14
    ct = eng.encrypt_complex(np.random.default_rng(5).normal(size=128), 6,
                             SCALE)
    assert _ip_calls(lambda: workloads.matvec_bsgs(ct.data, prep)) == 14


def test_kernel_refuses_what_it_does_not_take():
    dc = DeviceContext(get_params(64, 6, 2), "cpu")
    convs, d_eval, key, kt = _inputs(dc, 6, None, False, 1)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ip_kernel(convs, d_eval, key, kt)
    with pytest.raises(TypeError, match="dtype"):
        ip_kernel(convs, d_eval.long(), key, kt)
    with pytest.raises(TypeError, match="dtype"):
        ip_kernel([convs[0].long()] + convs[1:], d_eval, key, kt)
    with pytest.raises(ValueError, match="shape"):
        ip_kernel([convs[0][1:]] + convs[1:], d_eval, key, kt)
    with pytest.raises(ValueError, match="not contiguous"):
        ip_kernel([convs[0].transpose(-1, -2)] + convs[1:], d_eval, key, kt)
    with pytest.raises(ValueError, match="key"):
        ip_kernel(convs, d_eval, key[:, :, :, :-1], kt)
    with pytest.raises(ValueError, match="conversion pieces"):
        ip_kernel(convs[:2], d_eval, key, kt)
    # 17 digits (alpha 1 at level 17): more than the kernel takes
    many = DeviceContext(get_params(64, 17, 1), "cpu")
    convs, d_eval, key, kt = _inputs(many, 17, None, False, 2)
    assert len(kt.digits) == 17
    with pytest.raises(ValueError, match="at most 16"):
        ip_kernel(convs, d_eval, key, kt)
    # ... which the plain version, the CPU's route, still takes
    assert torch.equal(
        ip_plain(convs, d_eval, key, kt)[0],
        torch.cat(_int64_route(convs, d_eval, key, kt)[0]).to(torch.int32))


@pytest.mark.parametrize("op", ["hmult", "hsquare", "hrotate", "hoisted"])
def test_engine_ops_equal_ref(eng, cts, op):
    a, b = cts[0], cts[1]
    ra, rb = eng.to_ref(a), eng.to_ref(b)
    if op == "hoisted":
        got = eng.hrotate_hoisted(a, [1, 2])
        for g, s in zip(got, (1, 2)):
            assert np.array_equal(eng.dc.download(g.data),
                                  eng.ref.hrotate(ra, s).data)
        return
    got, want = {
        "hmult": (lambda: eng.hmult(a, b), lambda: eng.ref.hmult(ra, rb)),
        "hsquare": (lambda: eng.hsquare(a), lambda: eng.ref.hmult(ra, ra)),
        "hrotate": (lambda: eng.hrotate(a, 1),
                    lambda: eng.ref.hrotate(ra, 1)),
    }[op]
    assert np.array_equal(eng.dc.download(got().data), want().data)


@pytest.mark.card
def test_kernel_on_the_card(card):
    """On a CUDA GPU: B18 against ip_plain (on the card) bit for bit at N =
    2^13, maxLevel 8, alpha 3 (a partial digit): one ciphertext, a batch
    of 4, all q - 1, automorphed pieces (the hoisted route's) and a 4-way
    column slice; one launch each. Then the engine on the card: hmult,
    hsquare, hrotate(1) and hrotate_hoisted([1, 2]) equal the CPU plain
    path, launching B18 once a key switch, and a 64 x 64 matvec at g = 8
    launches it 14 times."""
    p = get_params(1 << 13, 8, 3)
    dc = DeviceContext(p, "cuda")
    perm = dc.automorph_perm(p.galois_elt(5))
    for level, batch, worst, how in ((8, None, False, ""),
                                     (7, 4, False, ""), (8, 2, True, ""),
                                     (8, None, False, "hoisted"),
                                     (8, 3, False, "slice")):
        convs, d_eval, key, kt = _inputs(dc, level, batch, worst, level,
                                         "cuda")
        if how == "hoisted":
            convs = [automorph_eval(c, perm) for c in convs]
            d_eval = automorph_eval(d_eval, perm)
        if how == "slice":
            c = p.ntt.n1 // 4
            convs, d_eval, key = ([t[..., c:2 * c].contiguous() for t in v]
                                  for v in (convs, [d_eval], [key]))
            d_eval, key = d_eval[0], key[0]
        kernels.reset_launch_counts()
        got = ip_kernel(convs, d_eval, key, kt)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["ip"] == 1
        assert torch.equal(got, ip_plain(convs, d_eval, key, kt)), \
            (level, batch, worst, how)
    eng = CkksEngine(p, 7, device="cuda")
    eng.keygen()
    cpu = CkksEngine(p, device="cpu")
    cpu.ref = eng.ref
    rng = np.random.default_rng(1)
    a, b = (eng.encrypt_complex(rng.normal(size=p.n // 2), 8, SCALE)
            for _ in range(2))
    ac, bc = (Ciphertext(x.data.cpu(), x.level, x.scale) for x in (a, b))
    for op, run, switches in (
            ("hmult", lambda e, x, y: [e.hmult(x, y)], 1),
            ("hsquare", lambda e, x, y: [e.hsquare(x)], 1),
            ("hrotate", lambda e, x, y: [e.hrotate(x, 1)], 1),
            ("hoisted", lambda e, x, y: e.hrotate_hoisted(x, [1, 2]), 2)):
        run(eng, a, b)  # makes the rotation keys
        cpu.relin_key = eng.relin_key.cpu()
        cpu.rot_keys = {s: k.cpu() for s, k in eng.rot_keys.items()}
        kernels.reset_launch_counts()
        got = run(eng, a, b)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["ip"] == switches, op
        for g, w in zip(got, run(cpu, ac, bc)):
            assert torch.equal(g.data.cpu(), w.data), op
    M = np.random.default_rng(4).normal(size=(64, 64)) / 64
    prep = workloads.matvec_prep(eng, M, 8, SCALE, 8)
    kernels.reset_launch_counts()
    workloads.matvec_bsgs(a.data, prep)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ip"] == 14
