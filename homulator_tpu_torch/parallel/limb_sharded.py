"""Limb-axis (RNS-row) sharded hmult and hrotate, and their hybrid form on
a limb x coeff mesh: the port of `homulator_tpu/parallel/limb_sharded.py`.

The limb dispatch is the reference's primary one (every per-limb unit of
work on cluster `limb % cluster`, Driver.h:155-191): each shard holds a
block of RNS rows and runs whole, unsplit transforms on them (B1, B2), so
the machine scales by transform count, not transform size:

  * every multi-row transform batch (the ModUp iNTT, the digits' NTTs, the
    ModDown and tail transforms) splits its rows over the shards;
  * each shard computes complete rows of the key-switch accumulator for
    its block of the extended basis: base conversion B3 produces any
    output-row slice from the full digit input, and the digit's own rows
    come out of the same contraction exactly (only the t = j term of
    sum_t xhat_t * [Q_d/q_t] survives mod q_j, and the centering term
    v * Q_d vanishes mod q_j), so each shard runs B3 over its whole ext
    block, own rows included, and the digit inner product against the
    row-sharded key needs no reduction across shards;
  * the only exchanges are row-block all_gathers over the limb axis, two
    sites an op, each cut into G column chunks (`pick_gchunks`): the
    coeff-domain input rows that feed every digit's conversion, and the
    ModDown specials (with, in hmult, the rescale's last-limb row).

Row padding: shard i of ns holds main rows [i*sm, (i+1)*sm), sm =
ceil(level/ns), and special rows [i*sa, (i+1)*sa), sa = ceil(alpha/ns);
its ext block is [its specials, its mains]. Pad rows carry the last real
prime's tables and garbage data: no digit contraction reads them (they
slice real rows only), the ModDown count row sums real specials only, and
the output is zero there.

Hybrid (`make_hybrid_*`): the same programs on a (limb x coeff) mesh, the
reference's limb dispatch composed with its 2-D BCONV/IP tiling
(Driver.h:209-285). Every tile's trailing axis is also split over the
coeff axis, each transform runs phase-split around an all_to_all within
the coeff group (per-limb phase kernels B6-B9, never the lane-packed
ones: a lane group of k rows would cross limb blocks), and the
automorphism is a whole-shard ppermute within the coeff group, or the
all_gather form where the column map is not block-aligned. The body binds
the coeff Comm as `current()` for the transforms (ops/ntt.py finds it
there) and takes the limb Comm explicitly.

The dispatch takes and returns operands laid out per shard, as the JAX
functions take arrays laid out over the mesh: `shard_rows` cuts a
ciphertext (or a batch of them) into each shard's row block and column
slice, `limb_key` the key into each shard's ext block, `gather_rows`
joins the result (pad rows included; the real ones come first).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..context import DeviceContext, NttBasis
from ..ops.automorph import (
    automorph_eval, automorph_eval_sharded, automorph_eval_shardperm,
)
from ..ops.bconv_fused import bconv_fused
from ..ops.keyswitch import _over_rows
from ..ops.modmath import (
    col, lazy_sum_reduce, lazy_tree_sum, modadd, modsub, mont_mul, mulmod,
    shoup_mul,
)
from ..ops.ntt import intt_rep, ntt_rep
from .comm import bound
from .sharded import _check_data_axis


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass
class LimbDigitTables:
    """Digit-d ModUp tables of one shard: step 1 over the digit's primes
    (in_q), and the conversion matrix rows of the shard's ext block (own
    rows included), plain (`mat`, read by the plain version) and as B3's
    table (horner_sh, mat_mma; DeviceContext._bf16)."""

    step1: torch.Tensor
    step1_sh: torch.Tensor
    in_q: torch.Tensor
    mat: torch.Tensor
    horner_sh: torch.Tensor
    mat_mma: torch.Tensor
    lo: int
    hi: int


@dataclasses.dataclass
class LimbTables:
    """One shard's tables for a limb-sharded key switch at (level, ns):
    the JAX LimbTables' row blocks of shard `rank`, with the bases of its
    rows (coefficient-sharded for coeff rank `shard` = (r, ns_c) on a
    hybrid mesh).

    Rows: main [sm] (pad rows repeat level-1), specials [sa] (pad rows
    repeat the last special), ext [B = sa + sm] = [specials, mains];
    tailzl = [specials, the main row at local index j_zl] (the rescale's
    last limb level-1 lives at local row j_zl of shard owner_zl).
    Pairs (x, x_sh) are a constant and its Shoup quotient: p [P]_{q_i},
    pqinv [(P q_last)^{-1}]_{q_i} (1 on rows >= level-1), pinv
    [P^{-1}]_{q_i}, md1 [(P/p_j)^{-1}]_{p_j} per special row; md2l
    [P/p_j]_{q_last} with its centering entry; pinv_last [P^{-1}]_{q_last}.
    md_*: the ModDown conversion (hrotate), the shard's main rows of
    [P/p_j]_{q_i} and [-P]_{q_i}; tail_*: the fused ModDown + rescale
    conversion (hmult), the shard's rows of the tail matrix (zero from
    level-1 on); one_sp / one_tail: identity step-1 pairs over the alpha
    specials and the tail's alpha + 3 input rows (in_q_tail)."""

    q_main: torch.Tensor
    p: torch.Tensor
    p_sh: torch.Tensor
    pqinv: torch.Tensor
    pqinv_sh: torch.Tensor
    pinv: torch.Tensor
    pinv_sh: torch.Tensor
    q_sp: torch.Tensor
    md1: torch.Tensor
    md1_sh: torch.Tensor
    q_ext: torch.Tensor
    qinv_ext: torch.Tensor
    main_nt: NttBasis
    sp_nt: NttBasis
    ext_nt: NttBasis
    tailzl_nt: NttBasis
    digits: Tuple[LimbDigitTables, ...]
    md_mat: torch.Tensor
    md_mma: torch.Tensor
    md_hsh: torch.Tensor
    one_sp: torch.Tensor
    one_sp_sh: torch.Tensor
    q_sp_full: torch.Tensor
    tail_mat: torch.Tensor
    tail_mma: torch.Tensor
    tail_hsh: torch.Tensor
    one_tail: torch.Tensor
    one_tail_sh: torch.Tensor
    in_q_tail: torch.Tensor
    md2l: torch.Tensor
    md2l_sh: torch.Tensor
    pinv_last: torch.Tensor
    pinv_last_sh: torch.Tensor
    q_last: torch.Tensor
    level: int
    ns: int
    rank: int
    alpha: int
    sa: int
    sm: int
    owner_zl: int
    j_zl: int
    gchunks: int


def pick_gchunks(n1: int, width: int) -> int:
    """Gather pipeline depth G: each row-block all_gather is cut into G
    chunks of the tile's n1 axis, so chunk g's conversion can start while
    later chunks are in flight (the JAX package's overlap). G in (4, 2, 1)
    with n1 % G == 0, n1/G >= 8 and (n1/G) * width % 128 == 0, where width
    is the columns each shard holds: n2 on the limb mesh, n2/ns_c on a
    hybrid one. (The JAX `_pick_gchunks` checks the full n2 on both, so on
    a hybrid mesh it can pick chunks narrower than its own gate allows.)"""
    for g in (4, 2):
        if n1 % g == 0 and n1 // g >= 8 and ((n1 // g) * width) % 128 == 0:
            return g
    return 1


def build_limb_tables(dc: DeviceContext, level: int, ns: int, rank: int,
                      shard: Optional[Tuple[int, int]] = None) -> LimbTables:
    """Shard `rank`'s tables of the limb-sharded key switch at (level,
    ns), its bases coefficient-sharded as `shard` = (r, ns_c) on a hybrid
    mesh (DeviceContext.ntt_basis, never lane-packed). Cached on dc."""
    ck = ("limb", level, ns, rank, shard)
    if ck in dc._ks_cache:
        return dc._ks_cache[ck]
    p = dc.params
    if dc.ntt_mode == "jnp":
        raise NotImplementedError("the graph route (ntt_mode='jnp') has no "
                                  "sharded form")
    if not (1 <= level <= p.max_level and 0 <= rank < ns):
        raise ValueError(f"level {level}, rank {rank} of {ns}")
    alpha, L = p.alpha, p.max_level
    qn = p.q_arr
    sm, sa = _ceil_div(level, ns), _ceil_div(alpha, ns)
    # padded rows: pad main rows repeat level-1, pad specials the last one
    main = [min(m, level - 1) for m in range(rank * sm, (rank + 1) * sm)]
    sp = [L + min(j, alpha - 1) for j in range(rank * sa, (rank + 1) * sa)]
    ext = sp + main
    mr, sr, er = np.array(main), np.array(sp), np.array(ext)
    owner_zl = (level - 1) // sm
    j_zl = (level - 1) - owner_zl * sm

    def basis(rows):
        return dc.ntt_basis(tuple(rows), shard)

    digits = []
    for d in range(p.beta(level)):
        lo, hi = p.digit_range(level, d)
        s1, s1_sh = dc._pair(p.ks.modup_step1[(level, d)], qn[lo:hi])
        mat = p.ks.modup_step2[(level, d)][er]  # [B, nd+1]
        _, hsh, mma = dc._bf16(mat, qn[er])
        digits.append(LimbDigitTables(
            step1=s1, step1_sh=s1_sh, in_q=dc.tensor(qn[lo:hi]),
            mat=dc.tensor(mat), horner_sh=hsh, mat_mma=mma, lo=lo, hi=hi))

    md_mat = p.ks.moddown_step2[mr]  # [sm, alpha+1]
    _, md_hsh, md_mma = dc._bf16(md_mat, qn[mr])

    # the fused ModDown + rescale tail: context.DeviceContext._tail_tables'
    # matrix over the padded main rows, this shard's block; rows from
    # level-1 on (the dropped limb and the padding) are zero
    lm1 = level - 1
    q_last = int(qn[lm1])
    P = p.p_prod
    p_modq = np.array([P % int(q) for q in qn], dtype=np.uint64)
    rows = np.arange(rank * sm, (rank + 1) * sm)
    real = rows < lm1
    pq_inv = np.ones(sm, dtype=np.uint64)
    tail_mat = np.zeros((sm, alpha + 3), dtype=np.uint64)
    for j in np.flatnonzero(real):
        q = int(qn[rows[j]])
        pq_inv[j] = pow((P * q_last) % q, -1, q)
        tail_mat[j, :alpha + 1] = p.ks.moddown_step2[rows[j]]
        tail_mat[j, alpha + 1] = p_modq[rows[j]]
        tail_mat[j, alpha + 2] = (q - (P * q_last) % q) % q
    _, tail_hsh, tail_mma = dc._bf16(tail_mat, qn[mr])
    sp_q = qn[L:L + alpha]
    in_q_tail = np.concatenate(
        [sp_q, sp_q[:1], np.array([q_last, q_last], dtype=np.uint64)])
    one_tail, one_tail_sh = dc._pair(np.ones(alpha + 3, dtype=np.uint64),
                                     in_q_tail)
    one_sp, one_sp_sh = dc._pair(np.ones(alpha, dtype=np.uint64), sp_q)
    md2l, md2l_sh = dc._pair(p.ks.moddown_step2[lm1],
                             np.full(alpha + 1, q_last, dtype=np.uint64))
    pinv_l, pinv_l_sh = dc._pair(p.ks.pinv_modq[lm1:lm1 + 1],
                                 np.array([q_last], dtype=np.uint64))
    p_pl, p_sh = dc._pair(p_modq[mr], qn[mr])
    pqinv, pqinv_sh = dc._pair(pq_inv, qn[mr])
    pinv, pinv_sh = dc._pair(p.ks.pinv_modq[mr], qn[mr])
    md1, md1_sh = dc._pair(p.ks.moddown_step1[sr - L], qn[sr])
    T = LimbTables(
        q_main=dc.tensor(qn[mr]), p=p_pl, p_sh=p_sh,
        pqinv=pqinv, pqinv_sh=pqinv_sh, pinv=pinv, pinv_sh=pinv_sh,
        q_sp=dc.tensor(qn[sr]), md1=md1, md1_sh=md1_sh,
        q_ext=dc.tensor(qn[er]), qinv_ext=dc.tensor(p.qinv_neg[er]),
        main_nt=basis(main), sp_nt=basis(sp), ext_nt=basis(ext),
        tailzl_nt=basis(sp + [main[j_zl]]),
        digits=tuple(digits),
        md_mat=dc.tensor(md_mat), md_mma=md_mma, md_hsh=md_hsh,
        one_sp=one_sp, one_sp_sh=one_sp_sh, q_sp_full=dc.tensor(sp_q),
        tail_mat=dc.tensor(tail_mat), tail_mma=tail_mma, tail_hsh=tail_hsh,
        one_tail=one_tail, one_tail_sh=one_tail_sh,
        in_q_tail=dc.tensor(in_q_tail), md2l=md2l, md2l_sh=md2l_sh,
        pinv_last=pinv_l[0], pinv_last_sh=pinv_l_sh[0],
        q_last=torch.tensor(q_last, device=dc.device),
        level=level, ns=ns, rank=rank, alpha=alpha, sa=sa, sm=sm,
        owner_zl=owner_zl, j_zl=j_zl,
        gchunks=pick_gchunks(p.ntt.n1, p.ntt.n2 // (shard[1] if shard
                                                    else 1)),
    )
    dc._ks_cache[ck] = T
    return T


# ---- per-shard programs ----------------------------------------------------
# Every program takes its operands with any leading batch axes (a data-axis
# shard's [B/d, ...] block, or none) and counts tile axes from the end, so
# a batch runs as one program: each transform one launch over the batch's
# rep copies, each B3 call one launch with the batch as its grid's z axis,
# each all_gather one collective carrying every element's rows (the JAX
# body's vmap inside shard_map).
def _gather_chunks(x: torch.Tensor, G: int, lc) -> List[torch.Tensor]:
    """x [..., rows, n1, w] cut into G chunks along its tile's n1 axis,
    each made contiguous and all_gathered along the row axis over the limb
    Comm lc: G x [..., ns*rows, n1/G, w]."""
    return [lc.all_gather(ch.contiguous(), -3) for ch in x.chunk(G, -2)]


def _modup_convs(gparts: Sequence[torch.Tensor],
                 T: LimbTables) -> torch.Tensor:
    """Each digit's centered conversion (B3) onto the shard's whole ext
    block, chunk by chunk over the gathered coeff-domain chunks gparts (G x
    [..., ns*sm, n1/G, w]): int32 [..., beta*B, n1, w]. The compute that
    overlaps the ModUp gather's chunks in flight."""
    return torch.cat([torch.cat([
        bconv_fused(gp[..., dt.lo:dt.hi, :, :], dt.step1, dt.step1_sh,
                    dt.in_q, dt.mat, dt.mat_mma, dt.horner_sh, T.q_ext,
                    center=True)
        for gp in gparts], dim=-2) for dt in T.digits], dim=-3)


def _modup_ev_limb(d_eval: torch.Tensor, T: LimbTables, lc) -> torch.Tensor:
    """ModUp, rows sharded: iNTT of the shard's rows [..., sm, n2, w], G
    chunked all_gathers of the coeff-domain rows, each digit's conversion
    onto the shard's ext block (`_modup_convs`), then one NTT over every
    digit's ext rows (rep = beta copies an element). Returns int32 [...,
    beta*B, n2, n1] (its column slice on a hybrid mesh)."""
    c_my = _over_rows(intt_rep, d_eval.to(torch.int32), T.main_nt)
    gparts = _gather_chunks(c_my, T.gchunks, lc)  # G x [..., ns*sm, n1/G, w]
    convs = _modup_convs(gparts, T).unflatten(-3, (len(T.digits), -1))
    return _over_rows(ntt_rep, convs, T.ext_nt).flatten(-4, -3)


def _ip_slice(ev: torch.Tensor, key: torch.Tensor, T: LimbTables, lo: int,
              hi: int):
    """Digit inner product on rows [lo, hi) of the shard's ext block
    (ev [..., beta*B, n2, w]): per key component, sum_d ev_d * key[d, k]
    (Montgomery key, broadcast over the batch), int64 [..., hi-lo, n2, w]
    in [0, q). Complete accumulator rows: no reduction across shards."""
    B = T.sa + T.sm  # the ext block's rows
    q, qi = col(T.q_ext[lo:hi]), col(T.qinv_ext[lo:hi])
    return [lazy_sum_reduce([
        mont_mul(ev[..., d * B + lo:d * B + hi, :, :], key[d, k, lo:hi], q,
                 qi)
        for d in range(len(T.digits))], q) for k in (0, 1)]


def _row_mask(T: LimbTables, lc, upto: int) -> torch.Tensor:
    """[sm, 1, 1] True on the shard's rows below `upto` (lc.rank's block of
    the padded rows)."""
    rows = lc.rank * T.sm + torch.arange(T.sm, device=T.q_main.device)
    return (rows < upto)[:, None, None]


def _tensor_d01(a, b, q):
    """The tensor product's d0 = a0 b0 and d1 = a0 b1 + a1 b0 on the
    shard's rows of a, b [..., 2, sm, n2, w] (d2 = a1 b1 feeds the
    ModUp)."""
    (a0, a1), (b0, b1) = a.unbind(-4), b.unbind(-4)
    d0 = mulmod(a0, b0, q)
    return d0, modadd(mulmod(a0, b1, q), mulmod(a1, b0, q), q)


def _tail_convs(gfs: Sequence[torch.Tensor], T: LimbTables):
    """hmult's fused ModDown + rescale tail conversion, chunk by chunk over
    the gathered chunks gfs (G x [..., 2, ns*(sa+1), n1/G, w]: every
    shard's sa specials and last-limb slot): the last limb's w and its
    centering row, then B3 onto the shard's main rows. Returns ([tail
    conversions of key 0 by chunk], [of key 1]), each [..., sm, n1/G, w].
    The compute that overlaps the tail gather's chunks in flight."""
    sa, alpha = T.sa, T.alpha
    q_last = T.q_last.long()
    th = col((T.q_sp_full.long() >> 1) + 1)
    th_last = (q_last >> 1) + 1
    md2l, md2l_sh = col(T.md2l), col(T.md2l_sh)
    tcs = ([], [])
    for gf in gfs:
        # [..., 2, alpha, n1/G, w]: every shard's sa specials, the real alpha
        lead, tile = gf.shape[:-3], gf.shape[-2:]
        bhat = gf.view(lead + (T.ns, sa + 1) + tile)[..., :sa, :, :].reshape(
            lead + (T.ns * sa,) + tile)[..., :alpha, :, :]
        zl_coeff = gf[..., T.owner_zl * (sa + 1) + sa, :, :]
        v = (bhat >= th).sum(dim=-3, keepdim=True)
        bhat_ext = torch.cat([bhat.long(), v], dim=-3)
        terms = shoup_mul(bhat_ext, md2l, md2l_sh, q_last)
        conv_last = lazy_tree_sum(terms.movedim(-3, 0), q_last)
        w = shoup_mul(modsub(zl_coeff, conv_last, q_last), T.pinv_last,
                      T.pinv_last_sh, q_last)
        ind_w = (w >= th_last).long()  # w's centering row
        for k in (0, 1):
            tcs[k].append(bconv_fused(
                torch.cat([bhat_ext[..., k, :, :, :],
                           w[..., k, None, :, :], ind_w[..., k, None, :, :]],
                          dim=-3).to(torch.int32),
                T.one_tail, T.one_tail_sh, T.in_q_tail, T.tail_mat,
                T.tail_mma, T.tail_hsh, T.q_main))
    return tcs


def _moddown_convs(gfs: Sequence[torch.Tensor], T: LimbTables):
    """hrotate's ModDown conversion (B3) of the gathered specials onto the
    shard's main rows, chunk by chunk over gfs (G x [2, ns*sa, n1/G, w]).
    Returns ([conversions of key 0 by chunk], [of key 1])."""
    ccs = ([], [])
    for gf in gfs:
        for k in (0, 1):
            ccs[k].append(bconv_fused(
                gf[k, :T.alpha], T.one_sp, T.one_sp_sh, T.q_sp_full, T.md_mat,
                T.md_mma, T.md_hsh, T.q_main, center=True))
    return ccs


def _ntt_keys(convs, T: LimbTables) -> torch.Tensor:
    """Both key components' chunked main-row conversions ([key 0's chunks],
    [key 1's]), each chunk [..., sm, n1/G, w], joined and NTT'd in one
    launch (rep = 2 copies an element): int32 [..., 2, sm, n2, w]."""
    x = torch.stack([torch.cat(c, dim=-2) for c in convs], dim=-4)
    return _over_rows(ntt_rep, x, T.main_nt)


def _hmult_limb_body(a, b, key, T: LimbTables, lc) -> torch.Tensor:
    """Row-sharded hmult of the shard's blocks a, b [..., 2, sm, n2, n1]
    (a leading batch axis or none): tensor product, ModUp
    (`_modup_ev_limb`), the inner product's special and last-limb rows, a
    chunked gather of [2, sa+1] rows for the fused ModDown + rescale, the
    main-row inner product, the tail conversion (B3) and NTT of the
    shard's rows. Returns int32 [..., 2, sm, n2, n1], equal to
    api.hmult_graph on rows < level-1 and zero from there."""
    q = col(T.q_main)
    d0, d1 = _tensor_d01(a, b, q)
    ev = _modup_ev_limb(mulmod(a[..., 1, :, :, :], b[..., 1, :, :, :], q),
                        T, lc)
    sa, sm = T.sa, T.sm
    acc_sp = _ip_slice(ev, key, T, 0, sa)
    jz = sa + T.j_zl
    acc_zl = _ip_slice(ev, key, T, jz, jz + 1)
    q_zl = T.q_main[T.j_zl].long()
    xs = []
    for k, dd in enumerate((d0, d1)):
        # the last-limb slot: Z mod q_last (real on shard owner_zl only)
        zl_eval = modadd(acc_zl[k], shoup_mul(
            dd[..., T.j_zl:T.j_zl + 1, :, :], T.p[T.j_zl], T.p_sh[T.j_zl],
            q_zl), q_zl)
        xs.append(torch.cat([acc_sp[k], zl_eval], dim=-3))
    xc2 = _over_rows(intt_rep, torch.stack(xs, dim=-4).to(torch.int32),
                     T.tailzl_nt)  # [..., 2, sa+1, n1, w]
    bhat_my = shoup_mul(xc2[..., :sa, :, :], col(T.md1), col(T.md1_sh),
                        col(T.q_sp))
    g = torch.cat([bhat_my, xc2[..., sa:, :, :]], dim=-3).to(torch.int32)
    gfs = _gather_chunks(g, T.gchunks, lc)  # G x [..., 2, ns*(sa+1), n1/G, w]
    acc_mn = _ip_slice(ev, key, T, sa, sa + sm)
    e2 = _ntt_keys(_tail_convs(gfs, T), T)
    mask = _row_mask(T, lc, T.level - 1)
    outs = []
    for k, dd in enumerate((d0, d1)):
        z = modadd(acc_mn[k], shoup_mul(dd, col(T.p), col(T.p_sh), q), q)
        o = shoup_mul(modsub(z, e2[..., k, :, :, :], q), col(T.pqinv),
                      col(T.pqinv_sh), q)
        outs.append(torch.where(mask, o, 0))
    return torch.stack(outs, dim=-4).to(torch.int32)


def _hrotate_limb_body(a, key, T: LimbTables, lc, auto) -> torch.Tensor:
    """Row-sharded hrotate of the shard's block a [2, sm, n2, n1]: the
    automorphism `auto` (row-local on the limb mesh), ModUp, the special
    rows' inner product and iNTT, a chunked gather of the [2, sa] ModDown
    specials, the main-row inner product, the ModDown conversion (B3) and
    NTT of the shard's rows. Returns int32 [2, sm, n2, n1], equal to the
    single-device hrotate on rows < level and zero from there."""
    r0, r1 = auto(a[0]), auto(a[1])
    ev = _modup_ev_limb(r1, T, lc)
    sa, sm = T.sa, T.sm
    q = col(T.q_main)
    acc_sp = _ip_slice(ev, key, T, 0, sa)
    xc2 = _over_rows(intt_rep, torch.stack(acc_sp).to(torch.int32), T.sp_nt)
    bstack = shoup_mul(xc2, col(T.md1), col(T.md1_sh),
                       col(T.q_sp)).to(torch.int32)  # [2, sa, n1, w]
    gfs = _gather_chunks(bstack, T.gchunks, lc)
    acc_mn = _ip_slice(ev, key, T, sa, sa + sm)
    ce2 = _ntt_keys(_moddown_convs(gfs, T), T)
    es = [shoup_mul(modsub(acc_mn[k], ce2[k], q), col(T.pinv),
                    col(T.pinv_sh), q) for k in (0, 1)]
    mask = _row_mask(T, lc, T.level)
    return torch.stack([torch.where(mask, modadd(r0, es[0], q), 0),
                        torch.where(mask, es[1], 0)]).to(torch.int32)


# ---- entry points ----------------------------------------------------------
def _check_axes(mesh, names: Tuple[str, ...]) -> None:
    if tuple(getattr(mesh, "names", ())) != names:
        raise ValueError(f"mesh axes {getattr(mesh, 'names', None)}, "
                         f"expected {names}")


def _limb_tables(dc, level, mesh, axis, col_axis):
    """{(limb rank, coeff rank): tables} of every shard of a row."""
    ns_l = mesh.extent(axis)
    if col_axis is None:
        return {(r, 0): build_limb_tables(dc, level, ns_l, r)
                for r in range(ns_l)}
    ns_c = mesh.extent(col_axis)
    t = dc.params.ntt
    if t.n1 % ns_c or t.n2 % ns_c:
        raise ValueError(f"{ns_c} coeff shards do not divide n1={t.n1}, "
                         f"n2={t.n2}")
    return {(r, c): build_limb_tables(dc, level, ns_l, r, (c, ns_c))
            for r in range(ns_l) for c in range(ns_c)}


def _shard_run(mesh, tabs, axis, col_axis, program):
    """mesh.run of program(comm, T, lc) on each shard with its tables and
    limb Comm; on a hybrid mesh with the coeff Comm bound as current()."""
    def body(comm):
        lc = comm.axis(axis)
        if col_axis is None:
            return program(comm, tabs[lc.rank, 0], lc)
        cc = comm.axis(col_axis)
        with bound(cc):
            return program(comm, tabs[lc.rank, cc.rank], lc)
    return mesh.run(body)


def _make_hmult(dc, level, mesh, axis, col_axis, data_axis):
    if level < 2:
        raise ValueError(f"level {level}: hmult needs level >= 2 (rescale "
                         "drops one limb)")
    _check_data_axis(mesh, data_axis)
    tabs = _limb_tables(dc, level, mesh, axis, col_axis)

    def run(a, b, key) -> List[torch.Tensor]:
        return _shard_run(mesh, tabs, axis, col_axis, lambda comm, T, lc:
                          _hmult_limb_body(a[comm.index], b[comm.index],
                                           key[comm.rank], T, lc))

    return run


def make_limb_hmult(dc: DeviceContext, level: int, mesh, *,
                    axis: str = "limb", data_axis: Optional[str] = None):
    """hmult at `level` with the RNS rows sharded over mesh axis `axis` (a
    mesh of that one axis, e.g. ThreadMesh(ns, dev, names=("limb",))).
    Returns f(a, b, key) -> out over per-shard operands: a, b the
    shard_rows blocks [2, sm, n2, n1], key the limb_key blocks [dnum, 2, B,
    n2, n1], out each shard's [2, sm, n2, n1] (gather_rows: rows
    [0, level-1) the hmult result, the rest zero).

    With data_axis="data" over a mesh of d data rows: a and b are
    shard_rows(..., data=d) blocks [B/d, 2, sm, n2, n1] (indexed by
    Comm.index), each shard runs one body on its whole block (the JAX
    body's vmap: one element's kernel launches and collective calls, each
    covering the B/d elements, B/d times an element's bytes), and out is
    each shard's [B/d, 2, sm, n2, n1]."""
    _check_axes(mesh, (axis,))
    return _make_hmult(dc, level, mesh, axis, None, data_axis)


def make_hybrid_hmult(dc: DeviceContext, level: int, mesh, *,
                      row_axis: str = "limb", col_axis: str = "coeff",
                      data_axis: Optional[str] = None):
    """hmult on a (row_axis x col_axis) mesh: RNS rows sharded over
    row_axis and every tile's trailing axis over col_axis (each transform
    phase-split around an all_to_all in the coeff group, B6-B9). Operands
    as make_limb_hmult's with the trailing axis cut too (shard_rows with
    ns_c), key blocks likewise (limb_key with ns_c); data_axis as there."""
    _check_axes(mesh, (row_axis, col_axis))
    return _make_hmult(dc, level, mesh, row_axis, col_axis, data_axis)


def make_limb_hrotate(dc: DeviceContext, level: int, mesh, *,
                      axis: str = "limb"):
    """hrotate at `level` with the RNS rows sharded over `axis`. Returns
    f(a, perm, key) -> out (perm = dc.automorph_perm(g); operands as
    make_limb_hmult's); out rows [0, level) are the result, the rest
    zero. The automorphism is a row-local gather: no exchange."""
    _check_axes(mesh, (axis,))
    _check_data_axis(mesh, None)
    tabs = _limb_tables(dc, level, mesh, axis, None)

    def run(a, perm, key) -> List[torch.Tensor]:
        return _shard_run(mesh, tabs, axis, None, lambda comm, T, lc:
                          _hrotate_limb_body(
                              a[comm.index], key[comm.rank], T, lc,
                              lambda x: automorph_eval(x, perm)))

    return run


def make_hybrid_hrotate(dc: DeviceContext, level: int, mesh, *,
                        row_axis: str = "limb", col_axis: str = "coeff"):
    """hrotate on a (row_axis x col_axis) mesh. Returns f(a, route, key),
    route = dc.automorph_shard_route(g, ns_c): the automorphism is one
    whole-shard ppermute in the coeff group and a local gather (no
    exchange where the block map is the identity), or, on the gather
    sentinel (pairs None, local_src the whole permutation), an all_gather
    over the coeff group, the whole-tile gather and a re-slice."""
    _check_axes(mesh, (row_axis, col_axis))
    _check_data_axis(mesh, None)
    tabs = _limb_tables(dc, level, mesh, row_axis, col_axis)

    def run(a, route, key) -> List[torch.Tensor]:
        local_src, pairs, _ = route

        def program(comm, T, lc):
            cc = comm.axis(col_axis)
            if pairs is None:
                auto = lambda x: automorph_eval_sharded(x, local_src, cc)
            else:
                auto = lambda x: automorph_eval_shardperm(
                    x, local_src[cc.rank], pairs, cc)
            return _hrotate_limb_body(a[comm.index], key[comm.rank], T, lc,
                                      auto)
        return _shard_run(mesh, tabs, row_axis, col_axis, program)

    return run


# ---- layouts ---------------------------------------------------------------
def pad_main_rows(x: torch.Tensor, level: int, ns: int) -> torch.Tensor:
    """[..., level, R, C] -> [..., ns*ceil(level/ns), R, C], zero pad rows."""
    if x.shape[-3] != level:
        raise ValueError(f"{tuple(x.shape)}: expected {level} rows")
    pad = ns * _ceil_div(level, ns) - level
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-3] + (pad,)
                                     + tuple(x.shape[-2:]))], dim=-3)


def shard_rows(x: torch.Tensor, level: int, ns_l: int, ns_c: int = 1,
               data: int = 1) -> List[torch.Tensor]:
    """Per-shard operands of the limb (ns_c = 1) or hybrid dispatch: x
    [..., level, n2, n1] padded to ns_l row blocks of sm rows, each cut
    into ns_c column slices; element l*ns_c + c is limb rank l's block,
    coeff rank c's slice [..., sm, n2, n1/ns_c]. With data = d, x is a
    batch [B, ...] cut first into d blocks of B/d (Comm.index order)."""
    if x.shape[-1] % ns_c:
        raise ValueError(f"trailing axis of {tuple(x.shape)} does not split "
                         f"into {ns_c} shards")
    if data > 1:
        if x.shape[0] % data:
            raise ValueError(f"batch of {x.shape[0]} does not split into "
                             f"{data} data rows")
        return [p for blk in x.chunk(data, dim=0)
                for p in shard_rows(blk, level, ns_l, ns_c)]
    return [c.contiguous()
            for blk in pad_main_rows(x, level, ns_l).chunk(ns_l, dim=-3)
            for c in blk.chunk(ns_c, dim=-1)]


def gather_rows(parts: Sequence[torch.Tensor], ns_l: int, ns_c: int = 1,
                data: int = 1) -> torch.Tensor:
    """The whole padded array (batch) from shard_rows' list of blocks."""
    n = ns_l * ns_c
    if data > 1:
        return torch.cat([gather_rows(parts[r * n:(r + 1) * n], ns_l, ns_c)
                          for r in range(data)], dim=0)
    return torch.cat([torch.cat(list(parts[r * ns_c:(r + 1) * ns_c]), dim=-1)
                      for r in range(ns_l)], dim=-3)


def evk_limb_row_order(params, level: int, ns: int) -> np.ndarray:
    """Row indices mapping the specials-first key ([dnum, 2, K, n2, n1],
    rows [alpha specials, max_level mains]) to the limb ext order: shard
    i's block [its specials, its mains], pad rows repeating the last real
    row (their products land on masked output rows)."""
    alpha = params.alpha
    sm, sa = _ceil_div(level, ns), _ceil_div(alpha, ns)
    order = []
    for i in range(ns):
        order += [min(j, alpha - 1) for j in range(i * sa, (i + 1) * sa)]
        order += [alpha + min(m, level - 1)
                  for m in range(i * sm, (i + 1) * sm)]
    return np.array(order, dtype=np.int64)


def limb_key(key: torch.Tensor, params, level: int, ns_l: int,
             ns_c: int = 1) -> List[torch.Tensor]:
    """Per-shard key blocks: each limb rank's ext block of the key rows
    (evk_limb_row_order, one index_select on dim 2), cut into ns_c column
    slices; element l*ns_c + c as shard_rows. Indexed by Comm.rank."""
    order = torch.from_numpy(evk_limb_row_order(params, level, ns_l)).to(
        key.device)
    if key.shape[-1] % ns_c:
        raise ValueError(f"trailing axis of {tuple(key.shape)} does not "
                         f"split into {ns_c} shards")
    return [c.contiguous()
            for blk in key.index_select(2, order).chunk(ns_l, dim=2)
            for c in blk.chunk(ns_c, dim=-1)]


# ---- exchanged bytes and collective counts ---------------------------------
def ici_bytes_per_op_limb(params, level: int, ns: int,
                          op: str = "hmult") -> int:
    """Bytes one shard receives in one limb-sharded op (the JAX function
    of the same name, whose numbers it gives): two gather sites, each
    (ns-1) x the shard's row block of N 4-byte words a row: the ModUp
    input rows (sm) and the tail rows (2 (sa+1) in hmult, 2 sa in
    hrotate). Every transform and the automorphism are shard-local."""
    n = params.n
    sm, sa = _ceil_div(level, ns), _ceil_div(params.alpha, ns)
    if op == "hmult":
        rows = sm + 2 * (sa + 1)
    elif op == "hrotate":
        rows = sm + 2 * sa
    else:
        raise ValueError(op)
    return (ns - 1) * rows * n * 4


def ici_bytes_per_op_hybrid(params, level: int, ns_l: int, ns_c: int,
                            op: str = "hmult", *,
                            route_identity: bool = False) -> int:
    """Bytes one shard receives in one hybrid op (the JAX function of the
    same name): the limb gathers, each row a column slice of N/ns_c words;
    one all_to_all in the coeff group per transform call, (ns_c-1)/ns_c of
    its local rows (ModUp iNTT sm, the digits' NTTs beta B, the tails
    2 (sa+1) and 2 sm in hmult, 2 sa and 2 sm in hrotate; the port batches
    rep copies in one exchange, which moves the same rows); hrotate adds
    two whole-shard ppermutes of the local rows unless the route's block
    map is the identity."""
    n = params.n
    sm, sa = _ceil_div(level, ns_l), _ceil_div(params.alpha, ns_l)
    B = sa + sm
    beta = params.beta(level)
    if op == "hmult":
        g_rows, tf_rows = sm + 2 * (sa + 1), sm + beta * B + 2 * (sa + 1)
    elif op == "hrotate":
        g_rows, tf_rows = sm + 2 * sa, sm + beta * B + 2 * sa
    else:
        raise ValueError(op)
    tf_rows += 2 * sm
    gather = (ns_l - 1) * g_rows * (n // ns_c) * 4
    a2a = tf_rows * (n // ns_c) * 4 * (ns_c - 1) // ns_c
    autos = (2 * sm * (n // ns_c) * 4
             if op == "hrotate" and not route_identity else 0)
    return gather + a2a + autos


def limb_collective_count(params, level: int, ns: int, op: str = "hmult",
                          *, ns_c: int = 1) -> int:
    """Collective calls over the limb axis in one op: both gather sites as
    G chunked all_gathers each, G = pick_gchunks at the columns a shard
    holds (n2/ns_c on a hybrid mesh; the JAX function takes n2 there)."""
    del level, ns, op
    return 2 * pick_gchunks(params.ntt.n1, params.ntt.n2 // ns_c)
