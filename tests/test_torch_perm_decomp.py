"""The port's perm_decomp copy and the staged automorphism against the JAX
package, bit for bit (tolerance 0):

  * decompose_grid_perm's three stage maps equal the JAX module's for
    random permutations of small grids and for sigma_g on the [n2, n1]
    eval tile at n = 256 and 1024, and apply_staged_np gives the
    permutation;
  * automorph_eval_staged equals the JAX automorph_eval_staged and the
    port's flat automorph_eval on random limbs, with the context's maps;
  * DeviceContext.automorph_stage_maps is int64, cached per Galois
    element, and holds the decomposition's maps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu.ops import perm_decomp as jpd
from homulator_tpu.ops.automorph import (
    automorph_eval_staged as jax_staged,
)
from homulator_tpu_torch.api import get_params
from homulator_tpu_torch.context import DeviceContext
from homulator_tpu_torch.ops import perm_decomp as pd
from homulator_tpu_torch.ops.automorph import (
    automorph_eval, automorph_eval_staged,
)


@pytest.mark.parametrize("R,C,seed", [(2, 3, 0), (8, 16, 1), (16, 16, 2),
                                      (32, 8, 3)])
def test_random_perm_maps_equal_jax(R, C, seed):
    perm = np.random.default_rng(seed).permutation(R * C)
    ours, theirs = pd.decompose_grid_perm(perm, R, C), \
        jpd.decompose_grid_perm(perm, R, C)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    x = np.arange(R * C, dtype=np.int64).reshape(R, C)
    assert np.array_equal(pd.apply_staged_np(x, *ours).ravel(), perm)
    assert np.array_equal(pd.apply_staged_np(x[None], *ours)[0],
                          jpd.apply_staged_np(x[None], *theirs)[0])


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("step", [1, -1, 5])
def test_galois_maps_equal_jax(n, step):
    p = get_params(n=n, max_level=2, alpha=1)
    t = p.ntt
    perm = p.automorph_eval_perm(p.galois_elt(step))
    ours = pd.decompose_grid_perm(perm, t.n2, t.n1)
    for a, b in zip(ours, jpd.decompose_grid_perm(perm, t.n2, t.n1)):
        assert np.array_equal(a, b)
    x = np.arange(n, dtype=np.int64).reshape(t.n2, t.n1)
    assert np.array_equal(pd.apply_staged_np(x, *ours).ravel(), perm)


@pytest.mark.parametrize("n,step", [(256, 1), (1024, 3)])
def test_staged_automorph_equals_jax_and_flat(n, step):
    p = get_params(n=n, max_level=3, alpha=1)
    dc = DeviceContext(p, "cpu")
    g = p.galois_elt(step)
    s1, s2, s3 = dc.automorph_stage_maps(g)
    t = p.ntt
    rng = np.random.default_rng(n)
    x = rng.integers(0, 1 << 30, size=(2, 3, t.n2, t.n1), dtype=np.int64)
    xt = torch.from_numpy(x.astype(np.int32))
    got = automorph_eval_staged(xt, s1, s2, s3)
    assert got.dtype == torch.int32 and got.shape == xt.shape
    assert torch.equal(got, automorph_eval(xt, dc.automorph_perm(g)))
    want = np.asarray(jax_staged(
        jnp.asarray(x.astype(np.uint32)),
        *(jnp.asarray(m.numpy().astype(np.int32)) for m in (s1, s2, s3))))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # one limb [n2, n1] as well: the maps broadcast over no leading axis
    assert torch.equal(automorph_eval_staged(xt[0, 0], s1, s2, s3), got[0, 0])


def test_stage_maps_cached_int64():
    p = get_params(n=256, max_level=2, alpha=1)
    dc = DeviceContext(p, "cpu")
    g = p.galois_elt(1)
    maps = dc.automorph_stage_maps(g)
    assert dc.automorph_stage_maps(g) is maps
    assert dc._perm_cache[("stage", g)] is maps
    t = p.ntt
    want = pd.decompose_grid_perm(p.automorph_eval_perm(g), t.n2, t.n1)
    for m, w in zip(maps, want):
        assert m.dtype == torch.int64 and tuple(m.shape) == (t.n2, t.n1)
        assert np.array_equal(m.numpy(), w)
    # the flat permutation and the maps of another element stay apart
    assert dc.automorph_perm(g) is dc._perm_cache[g]
    assert dc.automorph_stage_maps(p.galois_elt(2)) is not maps
