"""The graph key-switch route of the port (`ntt_mode="jnp"`: modup_digit,
modup_all, moddown, keyswitch, rescale_poly in ops/keyswitch.py and
ops/rescale.py) vs the JAX package's functions of the same names on a
`CkksEngine(ntt_mode="jnp")`, bit for bit (tolerance 0), at the
conftest's small_params (n = 64, maxLevel 6, alpha 2) at levels 6 and 5
(a partial last digit). The accelerated branches of modup_digit_eval and
moddown (ntt_mode="auto") are held against the same JAX outputs: both
routes give the same bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu.api import CkksEngine as JaxEngine
from homulator_tpu.ops import keyswitch as jks
from homulator_tpu.ops.ntt import intt as jax_intt
from homulator_tpu.ops.rescale import rescale_poly as jax_rescale
from homulator_tpu_torch.context import DeviceContext
from homulator_tpu_torch.ops import keyswitch as ks
from homulator_tpu_torch.ops.ntt import intt
from homulator_tpu_torch.ops.rescale import rescale_poly

LEVELS = [6, 5]
MODES = ["jnp", "auto"]


@pytest.fixture(scope="module")
def jeng(small_params):
    e = JaxEngine(small_params, seed=7, ntt_mode="jnp")
    e.keygen()
    return e


@pytest.fixture(scope="module")
def dcs(small_params):
    return {m: DeviceContext(small_params, "cpu", m) for m in MODES}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _u32(t):
    return t.numpy().astype(np.int64).astype(np.uint32)


def _residues(p, rows, seed):
    """uint32 [len(rows), n2, n1] uniform residues of p's primes `rows`."""
    rng = np.random.default_rng(seed)
    t = p.ntt
    return np.stack([rng.integers(0, int(p.q_arr[r]), size=(t.n2, t.n1))
                     for r in rows]).astype(np.uint32)


@pytest.mark.parametrize("level", LEVELS)
def test_modup_digit_matches_jax(jeng, dcs, level):
    p = jeng.params
    jkt = jeng.dc.keyswitch_tables(level)
    kt = dcs["jnp"].keyswitch_tables(level)
    d_eval = _residues(p, range(level), seed=level)
    jc = jax_intt(jnp.asarray(d_eval), jkt.main_nt)
    c = intt(_t(d_eval), kt.main_nt)
    assert np.array_equal(_u32(c), np.asarray(jc))
    for d in range(p.beta(level)):
        want = np.asarray(jks.modup_digit(jc, jkt, d))
        got = ks.modup_digit(c, kt, d)
        assert got.shape == (p.alpha + level,) + tuple(c.shape[1:])
        assert np.array_equal(_u32(got), want), d


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("level", LEVELS)
def test_modup_all_both_branches(jeng, dcs, level, mode):
    jkt = jeng.dc.keyswitch_tables(level)
    kt = dcs[mode].keyswitch_tables(level)
    assert kt.graph == (mode == "jnp")
    d_eval = _residues(jeng.params, range(level), seed=10 + level)
    want = jks.modup_all(jnp.asarray(d_eval), jkt)
    got = ks.modup_all(_t(d_eval), kt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(_u32(g), np.asarray(w))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("level", LEVELS)
def test_moddown_both_branches(jeng, dcs, level, mode):
    p = jeng.params
    rows = list(range(p.max_level, p.num_primes)) + list(range(level))
    c_ext = _residues(p, rows, seed=20 + level)
    want = jks.moddown(jnp.asarray(c_ext), jeng.dc.keyswitch_tables(level))
    got = ks.moddown(_t(c_ext), dcs[mode].keyswitch_tables(level))
    assert np.array_equal(_u32(got), np.asarray(want))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("level", LEVELS)
def test_keyswitch_matches_jax(jeng, dcs, level, mode):
    d_eval = _residues(jeng.params, range(level), seed=30 + level)
    e0, e1 = jks.keyswitch(jnp.asarray(d_eval), jeng.relin_key,
                           jeng.dc.keyswitch_tables(level))
    key = _t(np.asarray(jeng.relin_key))
    got = ks.keyswitch(_t(d_eval), key, dcs[mode].keyswitch_tables(level))
    assert got.dtype == torch.int32
    assert np.array_equal(_u32(got), np.stack([e0, e1]))


@pytest.mark.parametrize("level", LEVELS)
def test_rescale_poly_matches_jax(jeng, dcs, level):
    p, dc = jeng.params, dcs["jnp"]
    c = _residues(p, range(level), seed=40 + level)
    want = jax_rescale(jnp.asarray(c), jeng.dc.ntt_basis((level - 1,)),
                       jeng.dc.ntt_basis(tuple(range(level - 1))),
                       jeng.dc.rescale_qinv_mont(level))
    rt = dc.rescale_tables(level)
    _, jpl, jsh = jeng.dc.rescale_qinv_mont(level)
    for ours, theirs in ((rt.qinv, jpl), (rt.qinv_sh, jsh),
                         (rt.last_nt.q, jeng.dc.ntt_basis((level - 1,)).q)):
        assert np.array_equal(_u32(ours), np.asarray(theirs))
    assert rt.out_nt.rows == tuple(range(level - 1))
    assert dc.keyswitch_tables(level).rescale is rt
    got = rescale_poly(_t(c), rt)
    assert np.array_equal(_u32(got), np.asarray(want))


def test_graph_tables_and_modes(small_params, dcs):
    """Under "jnp" the tables carry no fused tail (as the JAX package's)
    but the rescale tables, the step-2 matrices are the accelerated
    route's; other modes and the sharded graph route raise."""
    g, a = dcs["jnp"].keyswitch_tables(6), dcs["auto"].keyswitch_tables(6)
    assert g.graph and g.tail is None and g.rescale is not None
    assert not a.graph and a.tail is not None and a.rescale is None
    assert dcs["jnp"].keyswitch_tables(1).rescale is None
    assert torch.equal(g.md_mat, a.md_mat)
    assert all(torch.equal(x.mat, y.mat) for x, y in zip(g.digits, a.digits))
    for bad in ("pallas", "interpret"):
        with pytest.raises(ValueError, match="ntt_mode"):
            DeviceContext(small_params, "cpu", bad)
    with pytest.raises(NotImplementedError, match="coefficient-sharded"):
        dcs["jnp"].keyswitch_tables(6, shard=(0, 2))
