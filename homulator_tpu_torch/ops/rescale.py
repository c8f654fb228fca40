"""CKKS rescale: exact RNS division by the dropped prime.

The counterpart of `homulator_tpu/ops/rescale.py`: iNTT of the last limb,
its centered remainder re-NTT'd into each remaining basis, a subtract and a
product by [q_last^{-1}]_{q_i}. Drops one limb; the caller decrements the
level and divides the scale by q_last. The JAX package's Montgomery and
Shoup branches give the same bits; this is the Shoup one. The graph route
(`ntt_mode="jnp"`) and `CkksEngine.rescale` run it; the accelerated
hmult fuses it into ModDown (ops/keyswitch.moddown_rescale2).
"""

from __future__ import annotations

import math

import torch

from ..context import RescaleTables
from .modmath import col, modsub, shoup_mul
from .ntt import intt_rep, ntt_rep


def _reduce_small(v: torch.Tensor, q) -> torch.Tensor:
    """Reduce v < 2^30 modulo q > 2^28 by at most 3 conditional
    subtracts."""
    for _ in range(3):
        v = torch.where(v >= q, v - q, v)
    return v


def rescale_poly(c: torch.Tensor, rt: RescaleTables) -> torch.Tensor:
    """c: [level, n2, n1] eval tiles -> int32 [level-1, n2, n1] eval, on the
    tables of DeviceContext.rescale_tables(level): the dropped limb's basis,
    the remaining main basis and [q_last^{-1}]_{q_i}. Subtracts the
    CENTERED remainder r~ = r - q_last*[r >= ceil(q_last/2)]: without it the
    decrypt error gains a key-dependent DC bias (the r1*s cross term).
    c may carry leading axes ([..., level, n2, n1], e.g. both components
    of a batch of ciphertexts): each transform is then one launch over
    all of them."""
    level = c.shape[-3]
    rep = math.prod(c.shape[:-3])
    last = intt_rep(c[..., level - 1:level, :, :].to(torch.int32)
                    .reshape((rep,) + c.shape[-2:]), rt.last_nt,
                    rep).long()  # [rep, n1, n2] in [0, q_last)
    last = last.view(c.shape[:-3] + (1,) + last.shape[-2:])
    q_last = rt.last_nt.q[0].long()
    ind = last >= (q_last >> 1) + 1
    oq = col(rt.out_nt.q)
    # centered representative mod q_i: r + 2*q_i - q_last < 2*q_i when ind
    red = _reduce_small(torch.where(ind, last + (oq + oq - q_last), last),
                        oq)
    red_eval = ntt_rep(red.to(torch.int32).reshape((-1,) + red.shape[-2:]),
                       rt.out_nt, rep)
    diff = modsub(c[..., :level - 1, :, :],
                  red_eval.view(red.shape[:-2] + red_eval.shape[-2:]), oq)
    return shoup_mul(diff, col(rt.qinv), col(rt.qinv_sh),
                     oq).to(torch.int32)
