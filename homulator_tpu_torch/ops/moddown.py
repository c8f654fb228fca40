"""ModDown's elementwise steps: plain PyTorch versions and the wrappers of
kernels B19-B21 (csrc/moddown.cu).

Reached through `keyswitch._moddown` (every rotation's ModDown pair) and
`keyswitch.moddown_rescale2` (the hmult's ModDown with the
relinearisation add and the rescale, one division by P * q_last), which
run them between the port's other kernels (B2, B3, B1). Each dispatcher
(md_zl, md_head, md_tail) sends a CPU tensor to the plain version, on
int64 carriers (ops/modmath.py), and a CUDA tensor to the kernel, which
computes the same canonical residues on uint32. For key component k of
element b (lm1 = level - 1, the dropped limb):

  md_zl    zl[b, k]  = acc_k[b, lm1] + P * d_k[b, lm1] mod q_last
  md_head  rows of the tail conversion's input, from b[b, k] = iNTT of the
           special rows and zl's iNTT: bhat_j = b_j * [(P/p_j)^-1]_{p_j},
           the centering count v, w = (zl - conv_{q_last}(bhat, v)) *
           P^{-1} mod q_last and its centering indicator ind
  md_tail  out[b, k, i] = (acc_k[b, i] (+ P * d_k[b, i]) - e[b, k, i]) * c_i
           mod q_i, with c = (P q_last)^{-1} (rescale) or P^{-1} (ModDown)

The work is elementwise over the last two axes, so a column slice of a
coefficient-sharded basis ([R, C / ns] tiles) takes the same code. Each
kernel counts one launch under kernels.LAUNCHES["moddown"].
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import kernels
from ..context import KeySwitchLevelTables
from .modmath import col, lazy_tree_sum, modadd, modsub, shoup_mul


def _lead(t: torch.Tensor) -> tuple:
    """The batch axes of a [..., rows, R, C] piece: () or (B,)."""
    return tuple(t.shape[:-3])


def _one(v: torch.Tensor, i: int) -> torch.Tensor:
    """Element i of a per-row table as a one-word view (what a kernel
    reads of it)."""
    return v[i:i + 1]


# ---- md_zl (B19) ---------------------------------------------------------

def zl_traffic(acc0, acc1, d0, d1, kt: KeySwitchLevelTables):
    """(tensors read, other bytes) of one launch of md_zl: row lm1 of each
    accumulator and each d, q_last and [P]_{q_last}'s pair; zl written."""
    lm1, tt = kt.level - 1, kt.tail
    rows = [t[..., lm1, :, :] for t in (acc0, acc1, d0, d1)]
    return ((*rows, _one(kt.main_nt.q, lm1), _one(tt.p_modq, lm1),
             _one(tt.p_modq_sh, lm1)), 4 * 2 * rows[0].numel())


def zl_plain(acc0, acc1, d0, d1, kt: KeySwitchLevelTables) -> torch.Tensor:
    """Plain version of md_zl: acc_k (acc_main [..., level, R, C]) and d_k
    (the relinearisation add's [..., level, R, C]) -> int32 [..., 2, R, C],
    w's input Z = acc + P * d mod q_last in the eval domain."""
    lm1, tt = kt.level - 1, kt.tail
    q_last = kt.main_nt.q[lm1].long()
    return torch.stack([
        modadd(a[..., lm1, :, :],
               shoup_mul(d[..., lm1, :, :], tt.p_modq[lm1].long(),
                         tt.p_modq_sh[lm1], q_last), q_last)
        for a, d in ((acc0, d0), (acc1, d1))], dim=-3).to(torch.int32)


def md_zl(acc0, acc1, d0, d1, kt: KeySwitchLevelTables) -> torch.Tensor:
    """zl_plain on a CPU tensor (as the kernel in the byte count), kernel
    B19 on a CUDA tensor."""
    traffic = zl_traffic(acc0, acc1, d0, d1, kt)
    if acc0.device.type == "cpu":
        with kernels.as_kernel(*traffic):
            return zl_plain(acc0, acc1, d0, d1, kt)
    with kernels.unobserved():
        return zl_kernel(acc0, acc1, d0, d1, kt, traffic)


# ---- md_head (B20) -------------------------------------------------------

def head_traffic(b, zl, kt: KeySwitchLevelTables):
    """(tensors read, other bytes) of one launch of md_head: b, zl and the
    constants read; alpha + 3 rows a (b, k) written."""
    lm1, tt = kt.level - 1, kt.tail
    alpha = kt.special_nt.q.shape[0]
    reads = (b, zl, kt.special_nt.q, kt.md_s1, kt.md_s1_sh, tt.md2_last,
             tt.md2_last_sh, _one(kt.main_nt.q, lm1), _one(kt.pinv, lm1),
             _one(kt.pinv_sh, lm1))
    return reads, 4 * (alpha + 3) * zl.numel()


def head_plain(b, zl, kt: KeySwitchLevelTables) -> torch.Tensor:
    """Plain version of md_head: b int32 [..., 2, alpha, n1, n2] (the
    specials' coeff rows) and zl [..., 2, n1, n2] (md_zl's output, coeff
    domain) -> int32 [..., 2, alpha + 3, n1, n2], the tail conversion's
    input rows: bhat, the count row v_b, w and its indicator ind_w."""
    lm1, tt = kt.level - 1, kt.tail
    sp_q = col(kt.special_nt.q)
    bhat = shoup_mul(b, col(kt.md_s1), col(kt.md_s1_sh), sp_q)
    # centered conversion: explicit count row v_b, read by the [-P] column
    v_b = (bhat >= (sp_q >> 1) + 1).sum(dim=-3, keepdim=True)
    bhat_ext = torch.cat([bhat, v_b], dim=-3)  # [..., 2, alpha+1, n1, n2]
    q_last = kt.main_nt.q[lm1].long()
    # conv row of q_last (coeff domain): sum_j bhat_ext_j * [P/p_j]_{q_last}
    terms = shoup_mul(bhat_ext, col(tt.md2_last), col(tt.md2_last_sh),
                      q_last)
    conv_last = lazy_tree_sum(terms.movedim(-3, 0), q_last)
    # w = Z mod q_last, Z = floor(acc / P) + d, in the coeff domain
    w = shoup_mul(modsub(zl, conv_last, q_last), kt.pinv[lm1].long(),
                  kt.pinv_sh[lm1], q_last)
    # w centering indicator, read by the [-P*q_last] column
    ind_w = (w >= (q_last >> 1) + 1).long()
    return torch.cat([bhat_ext, w.unsqueeze(-3), ind_w.unsqueeze(-3)],
                     dim=-3).to(torch.int32)


def md_head(b, zl, kt: KeySwitchLevelTables) -> torch.Tensor:
    """head_plain on a CPU tensor (as the kernel in the byte count), kernel
    B20 on a CUDA tensor."""
    traffic = head_traffic(b, zl, kt)
    if b.device.type == "cpu":
        with kernels.as_kernel(*traffic):
            return head_plain(b, zl, kt)
    with kernels.unobserved():
        return head_kernel(b, zl, kt, traffic)


# ---- md_tail (B21) -------------------------------------------------------

def tail_traffic(mains, e, q, c, c_sh, ds=None, pm=None, pm_sh=None):
    """(tensors read, other bytes) of one launch of md_tail: the
    accumulators' and d's first rows rows, e and the per-row constants
    read; the output, e's size, written."""
    rows = e.shape[-3]
    reads = [m[..., :rows, :, :] for m in mains] + [e, q, c, c_sh]
    if ds is not None:
        reads += [d[..., :rows, :, :] for d in ds] + [pm[:rows], pm_sh[:rows]]
    return tuple(reads), 4 * e.numel()


def tail_plain(mains: Sequence[torch.Tensor], e: torch.Tensor, q, c, c_sh,
               ds: Optional[Sequence[torch.Tensor]] = None, pm=None,
               pm_sh=None) -> torch.Tensor:
    """Plain version of md_tail: for rep = len(mains) accumulators
    [..., >= rows, R, C] (and as many d's, when given), e [..., rep, rows,
    R, C] and per-row constants q, c/c_sh (and pm/pm_sh, [P]_{q_i}) ->
    int32 [..., rep, rows, R, C], (acc + P * d - e) * c mod q."""
    rows = e.shape[-3]
    qc = col(q)
    a = torch.stack([m[..., :rows, :, :] for m in mains], dim=-4)
    if ds is not None:
        d = torch.stack([x[..., :rows, :, :] for x in ds], dim=-4)
        a = modadd(a, shoup_mul(d, col(pm[:rows]), col(pm_sh[:rows]), qc),
                   qc)
    return shoup_mul(modsub(a, e, qc), col(c), col(c_sh), qc).to(torch.int32)


def md_tail(mains, e, q, c, c_sh, ds=None, pm=None,
            pm_sh=None) -> torch.Tensor:
    """tail_plain on a CPU tensor (as the kernel in the byte count), kernel
    B21 on a CUDA tensor."""
    traffic = tail_traffic(mains, e, q, c, c_sh, ds, pm, pm_sh)
    if e.device.type == "cpu":
        with kernels.as_kernel(*traffic):
            return tail_plain(mains, e, q, c, c_sh, ds, pm, pm_sh)
    with kernels.unobserved():
        return tail_kernel(mains, e, q, c, c_sh, ds, pm, pm_sh, traffic)


# ---- the kernels ---------------------------------------------------------

def _pieces(name: str, ts, dev, rows: int, lead: tuple, dtype=torch.int32):
    """Kernel operands for row-sliced pieces [*lead, >= rows, R, C]: each
    of `dtype` (else cast to it) with its rows contiguous, all one batch
    stride apart (else made contiguous). Returns (pieces, batch stride in
    words)."""
    ts = [t if t.dtype == dtype else t.to(dtype) for t in ts]
    for i, t in enumerate(ts):
        if t.device != dev:
            raise ValueError(f"{name}[{i}]: on {t.device}, expected {dev}")
        if _lead(t) != lead or t.shape[-3] < rows:
            raise ValueError(f"{name}[{i}]: shape {tuple(t.shape)} is not "
                             f"[{', '.join(map(str, lead))}{', ' if lead else ''}"
                             f">={rows}, R, C]")
    R, C = ts[0].shape[-2:]

    def fits(t):
        return (t.shape[-2:] == (R, C) and t.stride(-1) == 1
                and t.stride(-2) == C and t.stride(-3) == R * C)

    if not all(fits(t) for t in ts) or len({
            t.stride(0) for t in ts if lead}) > 1:
        ts = [t.contiguous() for t in ts]
    if any(kernels.ptr(t) % 16 for t in ts):
        raise ValueError(f"{name}: a piece is not 16-byte aligned")
    return ts, (ts[0].stride(0) if lead else 0)


def _plane(name: str, t: torch.Tensor) -> int:
    plane = t.shape[-2] * t.shape[-1]
    if plane % 4:
        raise ValueError(f"{name}: a row of {tuple(t.shape[-2:])} words is "
                         "not a multiple of 4 (16-byte vectors)")
    return plane


def _launch(t: torch.Tensor, fn, *args) -> None:
    if not t.is_cuda:
        raise ValueError(f"moddown: CUDA kernel called on {t.device}")
    lib = kernels.load()
    with torch.cuda.device(t.device):
        rc = getattr(lib, fn)(*args, kernels.stream(t))
    kernels.check(rc, fn)


def zl_kernel(acc0, acc1, d0, d1, kt: KeySwitchLevelTables,
              traffic=None) -> torch.Tensor:
    """Kernel B19 on the GPU: both components and the batch in one launch;
    counts one launch. Same arguments and result as zl_plain (acc int32
    and d int64, or cast to them)."""
    lm1, tt = kt.level - 1, kt.tail
    dev, lead = acc0.device, _lead(acc0)
    plane = _plane("md_zl", acc0)
    if len(lead) > 1:
        raise ValueError(f"md_zl: acc {tuple(acc0.shape)} is not [level, R, "
                         "C] or [B, level, R, C]")
    (a0, a1), acc_bs = _pieces("acc", (acc0, acc1), dev, kt.level, lead)
    (e0, e1), d_bs = _pieces("d", (d0, d1), dev, kt.level, lead,
                             torch.int64)
    for name, t in (("q", kt.main_nt.q), ("p_modq", tt.p_modq),
                    ("p_modq_sh", tt.p_modq_sh)):
        kernels.require_cuda_int32(name, t, dev)
    batch = lead[0] if lead else 1
    out = torch.empty(lead + (2,) + tuple(acc0.shape[-2:]), dtype=torch.int32,
                      device=dev)
    _launch(acc0, "hk_md_zl",
            kernels.ptr(a0[..., lm1, :, :]), kernels.ptr(a1[..., lm1, :, :]),
            acc_bs, kernels.ptr(e0[..., lm1, :, :]),
            kernels.ptr(e1[..., lm1, :, :]), d_bs, kernels.ptr(out),
            kernels.ptr(kt.main_nt.q[lm1:]), kernels.ptr(tt.p_modq[lm1:]),
            kernels.ptr(tt.p_modq_sh[lm1:]), plane, batch)
    kernels.count("moddown", *(traffic or zl_traffic(acc0, acc1, d0, d1, kt)))
    return out


def head_kernel(b, zl, kt: KeySwitchLevelTables, traffic=None) -> torch.Tensor:
    """Kernel B20 on the GPU: both components and the batch in one launch;
    counts one launch. Same arguments and result as head_plain."""
    lm1, tt = kt.level - 1, kt.tail
    alpha = kt.special_nt.q.shape[0]
    dev = b.device
    lead = tuple(b.shape[:-4])
    if len(lead) > 1 or b.ndim < 4 or b.shape[-4] != 2:
        raise ValueError(f"md_head: b {tuple(b.shape)} is not [(B,) 2, "
                         "alpha, R, C]")
    R, C = b.shape[-2:]
    plane = _plane("md_head", b)
    # a lane-packed basis' one-limb iNTT returns a strided view
    b, zl = b.contiguous(), zl.contiguous()
    kernels.require_cuda_int32("b", b, dev, lead + (2, alpha, R, C))
    kernels.require_cuda_int32("zl", zl, dev, lead + (2, R, C))
    for name, t, n in (("sp_q", kt.special_nt.q, alpha),
                       ("md_s1", kt.md_s1, alpha),
                       ("md_s1_sh", kt.md_s1_sh, alpha),
                       ("md2_last", tt.md2_last, alpha + 1),
                       ("md2_last_sh", tt.md2_last_sh, alpha + 1)):
        kernels.require_cuda_int32(name, t, dev, (n,))
    for name, t in (("q", kt.main_nt.q), ("pinv", kt.pinv),
                    ("pinv_sh", kt.pinv_sh)):
        kernels.require_cuda_int32(name, t, dev)
    out = torch.empty(lead + (2, alpha + 3, R, C), dtype=torch.int32,
                      device=dev)
    _launch(b, "hk_md_head", kernels.ptr(b), kernels.ptr(zl),
            kernels.ptr(out), kernels.ptr(kt.special_nt.q),
            kernels.ptr(kt.md_s1), kernels.ptr(kt.md_s1_sh),
            kernels.ptr(tt.md2_last), kernels.ptr(tt.md2_last_sh),
            kernels.ptr(kt.main_nt.q[lm1:]), kernels.ptr(kt.pinv[lm1:]),
            kernels.ptr(kt.pinv_sh[lm1:]), alpha, plane,
            lead[0] if lead else 1)
    kernels.count("moddown", *(traffic or head_traffic(b, zl, kt)))
    return out


def tail_kernel(mains, e, q, c, c_sh, ds=None, pm=None, pm_sh=None,
                traffic=None) -> torch.Tensor:
    """Kernel B21 on the GPU: every component and the batch in one launch;
    counts one launch. Same arguments and result as tail_plain
    (accumulators int32 and d int64, or cast to them)."""
    rep, rows = len(mains), e.shape[-3]
    dev, lead = e.device, _lead(mains[0])
    R, C = e.shape[-2:]
    plane = _plane("md_tail", e)
    e = e.contiguous()
    if len(lead) > 1 or rep not in (1, 2):
        raise ValueError(f"md_tail: {rep} accumulators {tuple(mains[0].shape)}"
                         " (1 or 2, [level, R, C] or [B, level, R, C])")
    kernels.require_cuda_int32("e", e, dev, lead + (rep, rows, R, C))
    accs, acc_bs = _pieces("acc", mains, dev, rows, lead)
    d_ptrs, d_bs = (None, None), 0
    if ds is not None:
        dd, d_bs = _pieces("d", ds, dev, rows, lead, torch.int64)
        d_ptrs = (kernels.ptr(dd[0]), kernels.ptr(dd[-1]))
        for name, t in (("pm", pm), ("pm_sh", pm_sh)):
            kernels.require_cuda_int32(name, t, dev)
            if t.shape[0] < rows:
                raise ValueError(f"md_tail: {name} has {t.shape[0]} rows, "
                                 f"not {rows}")
    for name, t in (("q", q), ("c", c), ("c_sh", c_sh)):
        kernels.require_cuda_int32(name, t, dev, (rows,))
    out = torch.empty_like(e)
    _launch(e, "hk_md_tail", kernels.ptr(accs[0]), kernels.ptr(accs[-1]),
            acc_bs, *d_ptrs, d_bs, int(ds is not None), kernels.ptr(e),
            kernels.ptr(out),
            kernels.ptr(q), None if pm is None else kernels.ptr(pm),
            None if pm_sh is None else kernels.ptr(pm_sh), kernels.ptr(c),
            kernels.ptr(c_sh), rep, rows, plane, lead[0] if lead else 1)
    kernels.count("moddown", *(traffic or tail_traffic(
        mains, e, q, c, c_sh, ds, pm, pm_sh)))
    return out
