"""Kernel B4's plain version and the fused HPIP key-switch route of the
port, bit for bit (tolerance 0):

  * hpip_plain / hpip_acc vs the JAX `hpip_acc`, its Pallas kernel run in
    interpret mode at n = 256, maxLevel 6, alpha 2, levels 6 and 5 (a
    partial digit), as tests/test_pallas_kernels.py runs it;
  * with `api.USE_FUSED_HPIP` on, hmult, hsquare and hrotate equal the
    piecewise route (the flag is restored by a fixture);
  * the pieces of the route (keyswitch_fused, moddown_pair) equal their
    piecewise counterparts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu.api import CkksEngine as JaxEngine
from homulator_tpu.ops import keyswitch as jks
from homulator_tpu.params import get_params
from homulator_tpu_torch import api
from homulator_tpu_torch.api import CkksEngine
from homulator_tpu_torch.context import DeviceContext, from_jax_state
from homulator_tpu_torch.ops import keyswitch as ks
from homulator_tpu_torch.ops.hpip import hpip_kernel, hpip_plain

from .conftest import random_limbs

SCALE = 2.0**29


@pytest.fixture(scope="module")
def interp():
    """The JAX engine on its Pallas kernels in interpret mode, and the
    port's CPU context with the JAX engine's key."""
    p = get_params(n=256, max_level=6, alpha=2)
    ep = JaxEngine(p, seed=13, ntt_mode="interpret")
    ep.keygen()
    dc = DeviceContext(p, "cpu")
    key = from_jax_state({"k": np.asarray(ep.relin_key)}, dc)["k"]
    return ep, dc, key


@pytest.fixture
def fused():
    """USE_FUSED_HPIP on for one test, restored after it."""
    prev = api.USE_FUSED_HPIP
    api.USE_FUSED_HPIP = True
    yield
    api.USE_FUSED_HPIP = prev


@pytest.fixture(scope="module")
def engine(small_params):
    eng = CkksEngine(small_params, seed=5, device="cpu")
    eng.keygen()
    eng.gen_rotation_key(1)
    return eng


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("level", [6, 5])
def test_hpip_plain_matches_jax_interpret(interp, level):
    ep, dc, key = interp
    p = ep.params
    t = p.ntt
    rng = np.random.default_rng(level)
    d_np = random_limbs(p, np.arange(level), rng).astype(np.uint32).reshape(
        level, t.n2, t.n1)
    jkt = ep.dc.keyswitch_tables(level)
    jconvs = jks.modup_convs_coeff(jnp.asarray(d_np), jkt)
    want = np.asarray(jks.hpip_acc(jconvs, jnp.asarray(d_np), ep.relin_key,
                                   jkt))
    kt = dc.keyswitch_tables(level)
    d_eval = from_jax_state({"d": d_np}, dc)["d"]
    convs = ks.modup_convs_coeff(d_eval, kt)
    for c, jc in zip(convs, jconvs):
        assert np.array_equal(_u32(c), np.asarray(jc))
    got = hpip_plain(convs, d_eval, key, kt)
    assert got.shape == (2, p.alpha + level, t.n2, t.n1)
    assert np.array_equal(_u32(got), want)
    assert torch.equal(ks.hpip_acc(convs, d_eval, key, kt), got)
    # ... and the piecewise inner product over the NTT'd pieces
    pieces = ks.inner_product_pieces(ks.modup_conv_all(d_eval, kt), d_eval,
                                     key, kt)
    for k in (0, 1):
        assert torch.equal(torch.cat(pieces[k]).int(), got[k])


@pytest.mark.parametrize("level", [6, 5])
def test_keyswitch_fused_matches_pieces(interp, level):
    ep, dc, key = interp
    p = ep.params
    rng = np.random.default_rng(20 + level)
    d_np = random_limbs(p, np.arange(level), rng).astype(np.uint32).reshape(
        level, p.ntt.n2, p.ntt.n1)
    kt = dc.keyswitch_tables(level)
    d_eval = from_jax_state({"d": d_np}, dc)["d"]
    e = ks.keyswitch_pieces(d_eval, key, kt)
    assert torch.equal(ks.keyswitch_fused(d_eval, key, kt), e)
    acc0, acc1 = ks.inner_product_pieces(ks.modup_conv_all(d_eval, kt),
                                         d_eval, key, kt)
    assert torch.equal(ks.moddown_pair(acc0, kt), e[0])
    assert torch.equal(ks.moddown_pair(acc1, kt), e[1])
    # the JAX key switch (its Pallas route, interpret mode): same (e0, e1)
    jkt = ep.dc.keyswitch_tables(level)
    je = jks.keyswitch_pieces(jnp.asarray(d_np), ep.relin_key, jkt)
    assert np.array_equal(_u32(e), np.stack([np.asarray(x) for x in je]))


@pytest.mark.parametrize("level", [6, 5])
@pytest.mark.parametrize("op", ["hmult", "hsquare", "hrotate"])
def test_fused_route_matches_pieces(engine, op, level):
    rng = np.random.default_rng(level)
    slots = engine.params.n // 2
    a = engine.encrypt_complex(rng.normal(size=slots), level, SCALE)
    b = engine.encrypt_complex(rng.normal(size=slots), level, SCALE)
    run = {"hmult": lambda: engine.hmult(a, b),
           "hsquare": lambda: engine.hsquare(a),
           "hrotate": lambda: engine.hrotate(a, 1)}[op]
    assert api.USE_FUSED_HPIP is False
    want = run()
    api.USE_FUSED_HPIP = True
    try:
        got = run()
    finally:
        api.USE_FUSED_HPIP = False
    assert got.level == want.level
    assert torch.equal(got.data, want.data)


def test_fused_route_matches_ref(engine, fused):
    """With the flag on (fixture), hmult and hrotate equal RefCkks."""
    assert api.USE_FUSED_HPIP is True
    rng = np.random.default_rng(9)
    slots = engine.params.n // 2
    a = engine.encrypt_complex(rng.normal(size=slots), 6, SCALE)
    b = engine.encrypt_complex(rng.normal(size=slots), 6, SCALE)
    ra, rb = engine.to_ref(a), engine.to_ref(b)
    assert np.array_equal(engine.dc.download(engine.hmult(a, b).data),
                          engine.ref.hmult(ra, rb).data)
    assert np.array_equal(engine.dc.download(engine.hrotate(a, 1).data),
                          engine.ref.hrotate(ra, 1).data)


def test_hpip_kernel_refuses_cpu_tensors(interp):
    """The CUDA wrapper launches or raises: called with a CPU tensor it
    refuses it (hpip() sends CPU tensors to hpip_plain)."""
    _, dc, key = interp
    kt = dc.keyswitch_tables(6)
    t = dc.params.ntt
    d_eval = torch.zeros((6, t.n2, t.n1), dtype=torch.int32)
    convs = ks.modup_convs_coeff(d_eval, kt)
    with pytest.raises(ValueError, match="CUDA kernel"):
        hpip_kernel(convs, d_eval, key, kt)
    assert hpip_plain(convs, d_eval, key, kt).abs().sum() == 0
