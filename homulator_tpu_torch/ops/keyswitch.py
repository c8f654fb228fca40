"""Hybrid key switching: both routes of `homulator_tpu/ops/keyswitch.py`.

The accelerated route (what the JAX package runs on its accelerator):

  modup_convs_coeff   iNTT of the main limbs, then per digit a centered
                      base conversion (B3) to the rows outside the digit
  modup_conv_all      ... and the NTT of each digit's converted rows
  inner_product_pieces  digit inner product against the Montgomery key
                      (kernel B18, ops/ip.py)
  hpip_acc            modup_conv_all's NTTs and the inner product fused in
                      one kernel (B4, ops/hpip.py) on the coeff pieces
  moddown_pair(2)     ModDown (divide by P) of one / both key components
  keyswitch_pieces    ModUp -> inner product -> ModDown (hrotate's switch)
  keyswitch_fused     the same through hpip_acc
  moddown_rescale2    ModDown, relinearisation add and rescale of both key
                      components as one division by P * q_last

The graph route (`ntt_mode="jnp"`, `KeySwitchLevelTables.graph`: what the
JAX package runs on every other backend, and what its engine's
`keyswitch_poly` exposes):

  modup_digit         one digit lifted to the whole ext basis, coeff
                      domain: step 1, the centering count row v, step 2
                      (B5, ops/bconv.py), own rows put back in place
  modup_digit_eval    ... NTT'd over the whole ext basis (graph), or the
                      accelerated route's B3 + own-row passthrough
  modup_all           iNTT once, then every digit's modup_digit_eval
  inner_product       digit inner product over the assembled ext digits
  moddown             ModDown of one component: step 1, v, B5 and P^{-1}
                      (graph), or B3 and P^{-1} (accelerated)
  inner_product_moddown, keyswitch
                      inner product, then each component's moddown

Each function computes what its JAX namesake computes, on the same tables,
so every array is the same canonical residue and both routes give the same
bits. On the accelerated route modup_convs_coeff, modup_conv_all,
inner_product_pieces, hpip_acc, moddown_pair2, keyswitch_pieces,
keyswitch_fused and moddown_rescale2 also take a batch:
[B, ...] wherever they take [...] (the JAX package's vmap of its hmult),
with every kernel launch covering the batch (B1/B2 over B rep copies,
B3/B4 with the batch as their grid's z axis) and the key and the tables
read, never repeated B times. NTTs, base conversions, the piecewise inner
product and ModDown's elementwise steps go through the kernel wrappers
(ops/ntt.py, ops/bconv_fused.py, ops/bconv.py, ops/hpip.py, ops/ip.py,
ops/moddown.py); the graph route's other elementwise steps are PyTorch
ops on int64 carriers (ops/modmath.py).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from .. import kernels
from ..context import KeySwitchLevelTables
from ..stats import NO_SPAN, span
from .bconv import bconv_step1_centered, bconv_step2
from .bconv_fused import bconv_fused
from .hpip import hpip_kernel, hpip_plain, traffic as hpip_traffic
from .ip import ip_kernel, ip_plain, traffic as ip_traffic
from .moddown import md_head, md_tail, md_zl
from .modmath import col, lazy_sum_reduce, modsub, mont_mul, shoup_mul
from .ntt import intt, intt_rep, ntt, ntt_rep


def _over_rows(transform, x: torch.Tensor, nb) -> torch.Tensor:
    """ntt_rep or intt_rep (`transform`) of x [..., M, R, C] over basis nb,
    each element of the leading axes one rep copy: one launch for them all
    (x [M, R, C] is one copy, as ntt / intt take it)."""
    y = transform(x.reshape((-1,) + x.shape[-2:]), nb,
                  math.prod(x.shape[:-3]))
    return y.view(x.shape[:-2] + y.shape[-2:])


def modup_convs_coeff(d_eval: torch.Tensor,
                      kt: KeySwitchLevelTables) -> List[torch.Tensor]:
    """Per digit, the converted OTHER rows (ext order minus the digit's own
    rows), coeff domain [m_other, n1, n2] int32 ([B, m_other, n1, n2] for
    a batch d_eval [B, level, n2, n1]: one B3 launch a digit)."""
    c_coeff = _over_rows(intt_rep, d_eval, kt.main_nt)
    return [
        bconv_fused(c_coeff[..., dt.lo:dt.hi, :, :], dt.step1, dt.step1_sh,
                    dt.in_q, dt.mat, dt.mat_mma, dt.horner_sh,
                    dt.other_nt.q, center=True)
        for dt in kt.digits
    ]


def modup_conv_all(d_eval: torch.Tensor,
                   kt: KeySwitchLevelTables) -> List[torch.Tensor]:
    """modup_convs_coeff, NTT'd: per digit [m_other, n2, n1] eval int32
    ([B, m_other, n2, n1] for a batch). A digit's own rows are d_eval
    itself (the conversion reproduces them exactly), so they skip the
    conversion and the NTT."""
    convs = modup_convs_coeff(d_eval, kt)
    return [_over_rows(ntt_rep, c, dt.other_nt)
            for c, dt in zip(convs, kt.digits)]


def inner_product_pieces(
    convs, d_eval: torch.Tensor, key: torch.Tensor, kt: KeySwitchLevelTables,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Digit inner product: for key component k, acc_k = sum_d ext_d *
    key[d, k] over the ext basis (specials first), where ext_d is digit d
    lifted to the ext basis (converted rows + own rows of d_eval), in one
    launch of kernel B18 (ops/ip.py) for both components. Returns per k
    the pair (acc_sp [alpha, n2, n1], acc_main [level, n2, n1]), int32
    views in [0, q) of one [2, alpha+level, n2, n1] tensor; for a batch
    (d_eval [B, level, n2, n1]) each with the batch axis first, the key
    read once for it. A CPU tensor runs ip_plain; a CUDA tensor launches
    B18."""
    if d_eval.device.type == "cpu":
        with kernels.as_kernel(*ip_traffic(convs, d_eval, key, kt)):
            acc = ip_plain(convs, d_eval, key, kt)
    else:
        with kernels.unobserved():
            acc = ip_kernel(convs, d_eval, key, kt)
    alpha = kt.special_nt.q.shape[0]
    return [(acc[..., k, :alpha, :, :], acc[..., k, alpha:, :, :])
            for k in (0, 1)]


def hpip_acc(convs, d_eval: torch.Tensor, key: torch.Tensor,
             kt: KeySwitchLevelTables) -> torch.Tensor:
    """Fused ModUp NTT + key inner product (kernel B4): convs are the
    COEFF-domain pieces of modup_convs_coeff. Returns int32
    [2, alpha+level, n2, n1] in [0, q): both accumulators over the ext
    basis, specials first ([B, 2, ...] for a batch, one launch pair).
    Equal to inner_product_pieces(modup_conv_all). A CPU tensor runs
    hpip_plain; a CUDA tensor launches kernel B4 (csrc/hpip.cu)."""
    if d_eval.device.type == "cpu":
        with kernels.as_kernel(*hpip_traffic(convs, d_eval, key, kt)):
            return hpip_plain(convs, d_eval, key, kt)
    with kernels.unobserved():
        return hpip_kernel(convs, d_eval, key, kt)


def _moddown(accs, kt: KeySwitchLevelTables) -> torch.Tensor:
    """ModDown of rep = len(accs) accumulator pairs in one batched pass
    (rep-stacked NTTs share the basis tables): (acc_main -
    conv_P(acc_sp)) * P^{-1} over the main basis, with the centered
    conversion. Returns int32 [rep, level, n2, n1]; for a batch (every
    piece [B, rows, n2, n1]) [B, rep, level, n2, n1]: B2, B3 and B1 one
    launch each over the B * rep copies, then md_tail (ops/moddown.py)."""
    rep = len(accs)
    alpha = kt.special_nt.q.shape[0]
    sp = torch.stack([a[0] for a in accs], dim=-4).to(torch.int32)
    b = _over_rows(intt_rep, sp, kt.special_nt)  # [..., rep, alpha, n1, n2]
    conv = bconv_fused(b.view((-1, alpha) + b.shape[-2:]), kt.md_s1,
                       kt.md_s1_sh, kt.special_nt.q, kt.md_mat, kt.md_mma,
                       kt.md_horner_sh, kt.main_nt.q, center=True)
    ce = _over_rows(ntt_rep, conv.view(b.shape[:-3] + conv.shape[-3:]),
                    kt.main_nt)
    return md_tail([a[1] for a in accs], ce, kt.main_nt.q, kt.pinv,
                   kt.pinv_sh)


def moddown_pair(acc, kt: KeySwitchLevelTables) -> torch.Tensor:
    """ModDown of one accumulator pair (acc_sp [alpha, n2, n1], acc_main
    [level, n2, n1]) without concatenating them. Returns int32
    [level, n2, n1]."""
    return _moddown([acc], kt)[0]


def moddown_pair2(acc0, acc1, kt: KeySwitchLevelTables) -> torch.Tensor:
    """Both key components' ModDown in one batched pass. Bit-identical to
    (moddown_pair(acc0), moddown_pair(acc1)); returns int32
    [2, level, n2, n1], or [B, 2, level, n2, n1] for a batch (each piece
    with a leading axis B)."""
    return _moddown([acc0, acc1], kt)


def route_span(name: str, kt: KeySwitchLevelTables, timed: bool = True):
    """stats.span(name, timed) on the accelerated route of one device;
    nothing on the graph route (kept for parity) or on a sharded basis
    (the shard programs of parallel/)."""
    if kt.graph or kt.main_nt.shard is not None:
        return NO_SPAN
    return span(name, timed)


def keyswitch_pieces(d_eval: torch.Tensor, key: torch.Tensor,
                     kt: KeySwitchLevelTables) -> torch.Tensor:
    """Key switch without rescale: piecewise ModUp, inner product, both
    ModDowns batched. Returns int32 [2, level, n2, n1] (e0, e1), or
    [B, 2, level, n2, n1] for a batch d_eval [B, level, n2, n1] (one
    program: every launch covers the batch, the key read once). Each
    step is a span (route_span): modup, inner_product, moddown."""
    with route_span("modup", kt):
        convs = modup_conv_all(d_eval, kt)
    with route_span("inner_product", kt):
        acc0, acc1 = inner_product_pieces(convs, d_eval, key, kt)
    with route_span("moddown", kt):
        return moddown_pair2(acc0, acc1, kt)


def keyswitch_fused(d_eval: torch.Tensor, key: torch.Tensor,
                    kt: KeySwitchLevelTables) -> torch.Tensor:
    """keyswitch_pieces through the fused HPIP kernel. The JAX function
    ends in two moddown_pair calls; this one ends in one moddown_pair2,
    which is bit-identical. Returns int32 [2, level, n2, n1] ([B, 2, ...]
    for a batch, as keyswitch_pieces). The same spans as
    keyswitch_pieces; inner_product also runs ModUp's NTTs."""
    with route_span("modup", kt):
        convs = modup_convs_coeff(d_eval, kt)
    with route_span("inner_product", kt):
        acc0, acc1 = hpip_acc(convs, d_eval, key, kt).unbind(-4)
    del convs  # not held through ModDown
    alpha = kt.special_nt.q.shape[0]
    with route_span("moddown", kt):
        return moddown_pair2(
            (acc0[..., :alpha, :, :], acc0[..., alpha:, :, :]),
            (acc1[..., :alpha, :, :], acc1[..., alpha:, :, :]), kt)


def moddown_rescale2(acc0, acc1, d0, d1,
                     kt: KeySwitchLevelTables) -> torch.Tensor:
    """Both key components' ModDown + relinearisation add + rescale, i.e.
    (acc_k + P * d_k) / (P * q_last) with centered remainders, in one
    batched pass (rep=2 NTTs share the basis tables). Returns int32
    [2, level-1, n2, n1]; for a batch (acc_k's pieces and d_k with a
    leading axis B) [B, 2, level-1, n2, n1]. Each port kernel is one
    launch over the 2B copies: B2 on the specials, md_zl, B2 on the
    dropped limb, md_head, B3 on the tail table, B1, md_tail (B19-B21:
    ops/moddown.py)."""
    tt = kt.tail
    b = _over_rows(intt_rep, torch.stack([acc0[0], acc1[0]], dim=-4)
                   .to(torch.int32), kt.special_nt)  # [..., 2, a, n1, n2]
    zl = md_zl(acc0[1], acc1[1], d0, d1, kt)  # [..., 2, n2, n1]
    zl_coeff = _over_rows(intt_rep, zl.unsqueeze(-3),
                          tt.last_nt).squeeze(-3)
    x = md_head(b, zl_coeff, kt)  # [..., 2, alpha+3, n1, n2]
    conv = bconv_fused(x.view((-1,) + x.shape[-3:]), tt.one, tt.one_sh,
                       tt.in_q, tt.mat, tt.mma, tt.horner_sh, tt.out_nt.q)
    e = _over_rows(ntt_rep, conv.view(x.shape[:-3] + conv.shape[-3:]),
                   tt.out_nt)
    return md_tail((acc0[1], acc1[1]), e, tt.out_nt.q, tt.pq_inv,
                   tt.pq_inv_sh, (d0, d1), tt.p_modq, tt.p_modq_sh)


# ---- the graph route (and the accelerated branches of its functions) ---

def modup_digit(c_coeff: torch.Tensor, kt: KeySwitchLevelTables,
                d: int) -> torch.Tensor:
    """Digit d of c (coeff domain, [level, n1, n2]) lifted to the ext basis:
    int32 [alpha+level, n1, n2], specials first. The graph route's
    centered conversion: step 1, the count row v, step 2 (B5) to the rows
    outside the digit, the digit's own rows put back in place."""
    dt = kt.digits[d]
    own = c_coeff[dt.lo:dt.hi].to(torch.int32)
    conv = bconv_step2(
        bconv_step1_centered(own, dt.step1, dt.step1_sh, dt.in_q),
        dt.mat, dt.mat_mma, dt.horner_sh, dt.other_nt.q)
    cut = kt.special_nt.q.shape[0] + dt.lo
    return torch.cat([conv[:cut], own, conv[cut:]])


def modup_digit_eval(d_eval: torch.Tensor, c_coeff: torch.Tensor,
                     kt: KeySwitchLevelTables, d: int) -> torch.Tensor:
    """Digit d lifted to the ext basis, eval domain: int32
    [alpha+level, n2, n1]. Graph route: the NTT of modup_digit over the
    whole ext basis. Accelerated route: the conversion reproduces the
    digit's own rows exactly, so they are copied from d_eval, and only the
    other rows run B3 and an NTT."""
    if kt.graph:
        return ntt(modup_digit(c_coeff, kt, d), kt.ext_nt)
    dt = kt.digits[d]
    conv = bconv_fused(c_coeff[dt.lo:dt.hi], dt.step1, dt.step1_sh, dt.in_q,
                       dt.mat, dt.mat_mma, dt.horner_sh, dt.other_nt.q,
                       center=True)
    conv_eval = ntt(conv, dt.other_nt)
    cut = kt.special_nt.q.shape[0] + dt.lo
    return torch.cat([conv_eval[:cut], d_eval[dt.lo:dt.hi].to(torch.int32),
                      conv_eval[cut:]])


def modup_all(d_eval: torch.Tensor, kt: KeySwitchLevelTables):
    """Decompose, ModUp and NTT every digit once: a tuple of int32
    [alpha+level, n2, n1]. The hoistable prefix of a key switch: an
    automorphism commutes with the digit decomposition, so rotations of
    one ciphertext can share it."""
    c_coeff = intt(d_eval.to(torch.int32), kt.main_nt)
    return tuple(modup_digit_eval(d_eval, c_coeff, kt, d)
                 for d in range(len(kt.digits)))


def inner_product(ext_digits, key: torch.Tensor,
                  kt: KeySwitchLevelTables) -> Tuple[torch.Tensor, ...]:
    """acc_k = sum_d ext_digit_d * key[d, k] over the ext basis (the key's
    specials-first prefix of alpha+level rows), for k = 0, 1: int64
    [alpha+level, n2, n1] in [0, q) each."""
    k_ext = kt.special_nt.q.shape[0] + kt.level
    q, qinv = col(kt.ext_nt.q), col(kt.ext_qinv)
    return tuple(
        lazy_sum_reduce([mont_mul(e, key[d, k, :k_ext], q, qinv)
                         for d, e in enumerate(ext_digits)], q)
        for k in (0, 1))


def moddown(c_ext: torch.Tensor, kt: KeySwitchLevelTables) -> torch.Tensor:
    """[alpha+level, n2, n1] eval over the ext basis (specials first) ->
    int32 [level, n2, n1] eval mod Q: (c_main - conv_P(c_sp)) * P^{-1}
    with the centered conversion. Graph route: step 1, the count row and
    step 2 (B5); accelerated route: moddown_pair (B3)."""
    alpha = kt.special_nt.q.shape[0]
    if not kt.graph:
        return moddown_pair((c_ext[:alpha], c_ext[alpha:]), kt)
    b = intt(c_ext[:alpha].to(torch.int32), kt.special_nt)
    conv = bconv_step2(
        bconv_step1_centered(b, kt.md_s1, kt.md_s1_sh, kt.special_nt.q),
        kt.md_mat, kt.md_mma, kt.md_horner_sh, kt.main_nt.q)
    conv_eval = ntt(conv, kt.main_nt)
    mq = col(kt.main_nt.q)
    diff = modsub(c_ext[alpha:], conv_eval, mq)
    return shoup_mul(diff, col(kt.pinv), col(kt.pinv_sh),
                     mq).to(torch.int32)


def inner_product_moddown(ext_digits, key: torch.Tensor,
                          kt: KeySwitchLevelTables):
    """Inner product, then each key component's ModDown on its own: the
    per-key tail of a key switch. Returns (e0, e1), int32
    [level, n2, n1] each."""
    acc0, acc1 = inner_product(ext_digits, key, kt)
    return moddown(acc0, kt), moddown(acc1, kt)


def keyswitch(d_eval: torch.Tensor, key: torch.Tensor,
              kt: KeySwitchLevelTables) -> torch.Tensor:
    """The JAX package's keyswitch(): modup_all, inner product, each
    component's moddown. Returns int32 [2, level, n2, n1] (e0, e1), to add
    to (c0, c1)."""
    return torch.stack(inner_product_moddown(modup_all(d_eval, kt), key, kt))
