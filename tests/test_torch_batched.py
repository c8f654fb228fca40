"""The one-program batched hmult on the CPU (the kernels' plain versions),
bit for bit (tolerance 0), at n = 256, maxLevel 8, alpha 4, level 8:

  * parallel.sharded.batched_hmult_fn against the JAX package's vmapped
    batched_hmult_fn at B = 1 and 3, on the piecewise and the fused route;
  * the batch is one program: it makes the kernel wrappers' calls of one
    element (B1/B2 over B rep copies, B3 and B4 once each as for one
    ciphertext), and each element equals the single-ciphertext hmult,
    whose output and calls are those of the unbatched graph;
  * bconv_plain and hpip_plain on a batch equal them element by element;
  * the declared traffic of B3 and B4 on a batch is B times an
    element's, the count op_cost_counters reads on the CPU and the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu.api import CkksEngine as JaxEngine
from homulator_tpu.parallel import sharded as jax_sh
from homulator_tpu.params import get_params
from homulator_tpu_torch import api
from homulator_tpu_torch.api import CkksEngine, hmult_graph
from homulator_tpu_torch.context import from_jax_state
from homulator_tpu_torch.ops import keyswitch as ks
from homulator_tpu_torch.ops.bconv_fused import bconv_fused, bconv_plain
from homulator_tpu_torch.ops.hpip import hpip_plain
from homulator_tpu_torch.ops.keyswitch import hpip_acc, modup_convs_coeff
from homulator_tpu_torch.parallel import sharded as sh
from homulator_tpu_torch.stats import OpCosts

SCALE = 2.0**29
LEVEL = 8


@pytest.fixture(scope="module")
def engines():
    """(JAX graph-route engine, port engine on the CPU), same seed and key
    order, so their keys are equal."""
    params = get_params(n=256, max_level=8, alpha=4)
    jeng = JaxEngine(params, seed=5, ntt_mode="jnp")
    eng = CkksEngine(params, seed=5, device="cpu")
    for e in (jeng, eng):
        e.keygen()
    return jeng, eng


@pytest.fixture(params=["piecewise", "fused"])
def route(request, monkeypatch):
    monkeypatch.setattr(api, "USE_FUSED_HPIP", request.param == "fused")
    return request.param


def _u32(t):
    return t.numpy().view(np.uint32)


def _batch(eng, B, seed):
    rng = np.random.default_rng(seed)
    return torch.stack([eng.encrypt_complex(rng.normal(size=128), LEVEL,
                                            SCALE).data for _ in range(B)])


@pytest.fixture(scope="module")
def jax_batch(engines):
    """(a, b, the JAX vmapped batched_hmult_fn's output) for a batch of 3,
    computed once (one compile) for both routes and both batch sizes:
    the B = 1 case is its first element, which a vmap computes alone."""
    jeng, _ = engines
    rng = np.random.default_rng(3)
    ja, jb = (jnp.stack([jeng.encrypt_complex(rng.normal(size=128), LEVEL,
                                              SCALE).data for _ in range(3)])
              for _ in range(2))
    f = jax.jit(jax_sh.batched_hmult_fn(jeng.dc, LEVEL))
    return ja, jb, np.asarray(f(ja, jb, jeng.relin_key))


@pytest.mark.parametrize("B", [1, 3])
def test_batched_hmult_fn_matches_jax_vmap(engines, jax_batch, route, B):
    jeng, eng = engines
    ja, jb, want = jax_batch
    t = from_jax_state({"a": np.asarray(ja[:B]), "b": np.asarray(jb[:B]),
                        "k": np.asarray(jeng.relin_key)}, eng.dc)
    got = sh.batched_hmult_fn(eng.dc, LEVEL)(t["a"], t["b"], t["k"])
    assert got.shape == (B, 2, LEVEL - 1, 16, 16)
    assert np.array_equal(_u32(got), want[:B])


def _wrapper_calls(fn):
    """fn's calls of the kernel wrappers the key switch reaches (B1/B2 by
    transform, each with its rep; B3; B4), in order."""
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        def spy(name, rep_of=None):
            f = getattr(ks, name)

            def wrapped(*args, **kw):
                calls.append((name, rep_of(args) if rep_of else None))
                return f(*args, **kw)
            mp.setattr(ks, name, wrapped)

        spy("ntt_rep", lambda a: a[2])
        spy("intt_rep", lambda a: a[2])
        for name in ("bconv_fused", "hpip_kernel", "hpip_plain"):
            spy(name)
        out = fn()
    return out, calls


def test_batch_is_one_program(engines, route):
    """B = 3 makes the wrapper calls of one ciphertext, each transform
    over 3 times the rep copies; every element equals the single hmult,
    which calls the wrappers as before (rep 1 or 2, no batch)."""
    _, eng = engines
    a, b = _batch(eng, 3, 1), _batch(eng, 3, 2)
    kt = eng.dc.keyswitch_tables(LEVEL)
    f = sh.batched_hmult_fn(eng.dc, LEVEL)
    got, batch_calls = _wrapper_calls(lambda: f(a, b, eng.relin_key))
    single, one_calls = _wrapper_calls(
        lambda: hmult_graph(a[1], b[1], eng.relin_key, kt))
    beta = len(kt.digits)
    assert [c[0] for c in batch_calls] == [c[0] for c in one_calls]
    assert [c[1] for c in batch_calls] == [
        None if r is None else 3 * r for _, r in one_calls]
    names = [c[0] for c in one_calls]
    fused = route == "fused"
    # one B3 a digit, one for ModDown's tail over both components
    assert names.count("bconv_fused") == beta + 1
    assert names.count("hpip_plain") == int(fused)
    assert names.count("ntt_rep") == (1 if fused else beta + 1)
    assert names.count("intt_rep") == 3
    assert torch.equal(got[1], single)
    for i in range(3):
        assert torch.equal(got[i], eng.hmult(
            eng.dc.upload_ct(eng.dc.download(a[i]), LEVEL, SCALE),
            eng.dc.upload_ct(eng.dc.download(b[i]), LEVEL, SCALE)).data)


def test_graph_route_batch_loops(engines):
    """ntt_mode="jnp": batched_hmult_fn keeps the per-element loop (A5)
    and gives the accelerated route's bits."""
    _, eng = engines
    g = CkksEngine(eng.params, seed=5, device="cpu", ntt_mode="jnp")
    a, b = _batch(eng, 2, 3), _batch(eng, 2, 4)
    got = sh.batched_hmult_fn(g.dc, LEVEL)(a, b, eng.relin_key)
    assert torch.equal(got, sh.batched_hmult_fn(eng.dc, LEVEL)(
        a, b, eng.relin_key))
    with pytest.raises(ValueError, match="one ciphertext a call"):
        hmult_graph(a, b, eng.relin_key, g.dc.keyswitch_tables(LEVEL))


def _conversions(kt):
    """B3's conversions at kt's level: (tables, center) of ModUp digit 0
    (centered), ModDown and the tail."""
    dt, tt = kt.digits[0], kt.tail
    return {
        "modup0": ((dt.step1, dt.step1_sh, dt.in_q, dt.mat, dt.mat_mma,
                    dt.horner_sh, dt.other_nt.q), True),
        "moddown": ((kt.md_s1, kt.md_s1_sh, kt.special_nt.q, kt.md_mat,
                     kt.md_mma, kt.md_horner_sh, kt.main_nt.q), True),
        "tail": ((tt.one, tt.one_sh, tt.in_q, tt.mat, tt.mma, tt.horner_sh,
                  tt.out_nt.q), False),
    }


@pytest.mark.parametrize("which", ["modup0", "moddown", "tail"])
def test_bconv_batch_equals_elements(engines, which):
    """bconv_plain and bconv_fused on [B, nd, R, C] (also a row slice of
    a larger batch, as modup_convs_coeff passes it) == each element; the
    declared bytes are B times an element's."""
    _, eng = engines
    kt = eng.dc.keyswitch_tables(LEVEL)
    (s, s_sh, in_q, mat, mma, hsh, out_q), center = _conversions(kt)[which]
    rng = np.random.default_rng(len(which))
    q = in_q.long().numpy()
    qpad = np.concatenate([q[:1], q, q[:1]])
    big = torch.from_numpy(rng.integers(
        0, qpad[:, None, None], size=(4, len(qpad), 16, 16)).astype(np.int32))
    x = big[:, 1:1 + len(q)]  # elements len(q) + 2 rows apart
    args = (s, s_sh, in_q, mat, out_q, center)
    got = bconv_plain(x, *args)
    assert got.shape == (4, out_q.shape[0], 16, 16) and got.is_contiguous()
    for i in range(4):
        assert torch.equal(got[i], bconv_plain(x[i], *args))
    fused_args = (s, s_sh, in_q, mat, mma, hsh, out_q)
    costs = []
    for xs in (x, x[0]):
        c = OpCosts()
        with c.counting():
            out = bconv_fused(xs, *fused_args, center=center)
        costs.append(c.hbm_bytes)
        assert torch.equal(out, got if xs.ndim == 4 else got[0])
    assert costs[0] == 4 * costs[1] > 0


def test_hpip_batch_equals_elements(engines):
    """hpip_plain on a batch (pieces [B, rows_d, n1, n2], d_eval [B,
    level, n2, n1]) == each element; hpip_acc's declared bytes are B
    times an element's."""
    _, eng = engines
    kt = eng.dc.keyswitch_tables(LEVEL)
    a = _batch(eng, 3, 5)
    d = a[:, 1].contiguous()
    convs = modup_convs_coeff(d, kt)
    got = hpip_plain(convs, d, eng.relin_key, kt)
    K = kt.ext_nt.q.shape[0]
    assert got.shape == (3, 2, K, 16, 16)
    costs = []
    for i in range(3):
        one = [c[i] for c in convs]
        assert torch.equal(got[i], hpip_plain(one, d[i], eng.relin_key, kt))
        assert all(torch.equal(c, c1) for c, c1 in
                   zip(modup_convs_coeff(d[i], kt), one))
    for args in ((convs, d), ([c[0] for c in convs], d[0])):
        c = OpCosts()
        with c.counting():
            hpip_acc(*args, eng.relin_key, kt)
        costs.append(c.hbm_bytes)
    assert costs[0] == 3 * costs[1] > 0
