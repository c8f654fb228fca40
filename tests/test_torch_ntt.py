"""Port NTT (plain PyTorch version of kernels B1/B2) vs the JAX package:
`ntt_pallas` / `intt_pallas` in interpret mode and the jnp graph path, bit
for bit (tolerance 0), at n = 256 (n1 = n2 = 16) and n = 128 (n1 = 8,
n2 = 16), with rep = 1 and 2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu.context import DeviceContext as JaxContext
from homulator_tpu.ops import ntt as jntt
from homulator_tpu.ops.ntt_pallas import intt_pallas, ntt_pallas
from homulator_tpu.params import get_params
from homulator_tpu_torch.context import DeviceContext
from homulator_tpu_torch.ops import ntt_kernels
from homulator_tpu_torch.ops.ntt import intt_rep, ntt_rep

ROWS = (4, 5, 0, 2)  # specials first, then mains (an ext-style basis)
_JNP_NTT = jax.jit(jntt.ntt)
_JNP_INTT = jax.jit(jntt.intt)


@pytest.fixture(scope="module", params=[256, 128], ids=["n256", "n128"])
def ctx(request):
    p = get_params(n=request.param, max_level=4, alpha=2)
    return (p, JaxContext(p, ntt_mode="interpret").ntt_basis(ROWS),
            JaxContext(p, ntt_mode="jnp").ntt_basis(ROWS),
            DeviceContext(p, "cpu").ntt_basis(ROWS))


def _residues(p, rep, shape, seed):
    rng = np.random.default_rng(seed)
    q = np.tile(p.q_arr[list(ROWS)], rep).astype(np.int64)
    return rng.integers(0, q[:, None, None], size=(len(q),) + shape,
                        dtype=np.int64).astype(np.uint32)


def _jnp_rep(fn, x, nb, rep):
    M = x.shape[0] // rep
    return np.concatenate([np.asarray(fn(jnp.asarray(x[k * M:(k + 1) * M]),
                                         nb)) for k in range(rep)])


def _port(fn, x, nb, rep):
    out = fn(torch.from_numpy(x.view(np.int32)), nb, rep)
    assert out.dtype == torch.int32
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize("rep", [1, 2])
def test_ntt_matches_pallas_and_jnp(ctx, rep):
    p, nb_pl, nb_jnp, nb = ctx
    t = p.ntt
    x = _residues(p, rep, (t.n1, t.n2), seed=rep)
    got = _port(ntt_rep, x, nb, rep)
    pallas = np.asarray(ntt_pallas(jnp.asarray(x), nb_pl.q, nb_pl.pfwd,
                                   n1=t.n1, n2=t.n2, interpret=True, rep=rep))
    assert got.shape == (rep * len(ROWS), t.n2, t.n1)
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, _jnp_rep(_JNP_NTT, x, nb_jnp, rep))


@pytest.mark.parametrize("rep", [1, 2])
def test_intt_matches_pallas_and_jnp(ctx, rep):
    p, nb_pl, nb_jnp, nb = ctx
    t = p.ntt
    x = _residues(p, rep, (t.n2, t.n1), seed=10 + rep)
    got = _port(intt_rep, x, nb, rep)
    pallas = np.asarray(intt_pallas(jnp.asarray(x), nb_pl.q, nb_pl.pinv,
                                    n1=t.n1, n2=t.n2, interpret=True,
                                    rep=rep))
    assert got.shape == (rep * len(ROWS), t.n1, t.n2)
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, _jnp_rep(_JNP_INTT, x, nb_jnp, rep))
    back = _port(ntt_rep, got, nb, rep)
    assert np.array_equal(back, x)


def test_tables_match_jax(ctx):
    """The port's primes, mid twiddles and Shoup quotients are the JAX
    kernel tables; its flat stage tables hold params' stage twiddles."""
    p, nb_pl, _, nb = ctx

    def u32(t):
        return t.numpy().view(np.uint32)

    _, _, mid, mid_sh, _, _ = (np.asarray(a) for a in nb_pl.pfwd)
    _, _, midi, midi_sh, _, _ = (np.asarray(a) for a in nb_pl.pinv)
    assert np.array_equal(u32(nb.q), np.asarray(nb_pl.q))
    for ours, theirs in ((nb.mid, mid), (nb.mid_sh, mid_sh),
                         (nb.mid_inv, midi), (nb.mid_inv_sh, midi_sh)):
        assert np.array_equal(u32(ours), theirs)
    r = list(ROWS)
    for flat, sub, attr in ((nb.tw1, p.ntt.sub1, "stage_tw"),
                            (nb.tw2, p.ntt.sub2, "stage_tw"),
                            (nb.itw1, p.ntt.sub1, "inv_stage_tw"),
                            (nb.itw2, p.ntt.sub2, "inv_stage_tw")):
        for s, stage in enumerate(getattr(sub, attr)):
            assert np.array_equal(u32(flat)[:, 1 << s: 2 << s], stage[r])


def test_kernel_wrappers_refuse_cpu_tensors(ctx):
    """The CUDA wrappers launch or raise: a CPU tensor never reaches them
    through ntt_rep, and called directly they refuse it."""
    p, _, _, nb = ctx
    x = torch.zeros((len(ROWS), p.ntt.n1, p.ntt.n2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ntt_kernels.ntt_fwd(x, nb)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ntt_kernels.ntt_inv(x.transpose(1, 2).contiguous(), nb)
