"""4-step negacyclic NTT / iNTT over RNS limb arrays.

The counterpart of `homulator_tpu/ops/ntt.py`. N = n1 * n2:

  forward  [M, n1, n2] coeff tiles: CT stages along n1 (stage twiddles
           `params.ntt.sub1.stage_tw`), mid twiddle `tw_mid`, transpose,
           CT stages along n2 -> [M, n2, n1] eval tiles
  inverse  [M, n2, n1] eval tiles: GS stages along n2, transpose, mid
           twiddle `tw_mid_inv` (carries 1/N), GS stages along n1
           -> [M, n1, n2] coeff tiles

Same butterfly network as `_ct_stages` / `_gs_stages` of the JAX package,
so the output order is its permuted evaluation order and every output is
the same canonical residue. `*_rep` transform rep stacked arrays over one
basis (tables shared: row i uses basis row i % M).

On a coefficient-sharded basis (`nb.shard`, inside a shard program of
parallel/comm.py) each transform is the phase-split form of the JAX
package's `_ntt_sharded` / `_intt_sharded`: the butterfly phases run on
this shard's column slices and the [n1, n2] transpose is one all_to_all:

  forward  [R, n1, n2/ns] -> phase 1 (B6: stage 1, mid slice) -> all_to_all
           + local transpose -> [R, n2, n1/ns] -> phase 2 (B7: stage 2)
  inverse  [R, n2, n1/ns] -> phase 2 (B8: inverse stage 2) -> all_to_all +
           local transpose -> [R, n1, n2/ns] -> phase 1 (B9: mid_inv slice,
           inverse stage 1)

On a lane-packed basis (`nb.pack` = k > 0: the JAX package's default at
c = n/ns <= 32 columns) the phases are B10-B13 on [G, n, k*c] lane groups
(`pack_limb_lanes`: lane block j holds limb j's c columns) and the
exchange stays packed (`_packed_transpose_a2a`); each rep copy's rows are
padded to a multiple of k with copies of its last row, so the exchange
carries the rows the JAX package's exchanges carry.

The JAX package splits a rep-stacked sharded transform into per-copy calls
(ops/ntt.py:227-236); here the rep copies stay in one launch per phase and
one exchange (the kernels index tables by limb % M, or by lane group mod
G when packed), which moves the same rows and gives the same bits.

Dispatch: a CPU tensor runs the plain PyTorch version below; a CUDA tensor
goes to the hand-written kernels (ops/ntt_kernels.py, csrc/ntt.cu).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..context import NttBasis
from ..parallel import comm as comm_mod
from . import ntt_kernels
from .modmath import modadd, modsub, mulmod


def _ct_stages(x: torch.Tensor, tw: torch.Tensor, q: torch.Tensor,
               mul=None):
    """CT (DIT) butterflies along axis -2 of int64 [..., n, m]; tw int64
    [..., n] flat stage twiddles and q int64 [..., 1, 1, 1], each
    broadcasting against x's leading axes ([R, n] and [R, 1, 1, 1]
    against [R, n, m], or a basis' [M, n] against [rep, M, n, m]).
    mul(v, lo, hi), when given, is the twiddle product of v [..., B, H,
    m] by the columns lo:hi of the stage tables (ops/anatomy.py's Shoup
    forms); else mulmod."""
    *lead, n, m = x.shape
    for s in range(n.bit_length() - 1):
        B, H = 1 << s, n >> (s + 1)
        u, w = x.reshape(*lead, B, 2, H, m).unbind(-3)
        v = (mulmod(w, tw[..., B: 2 * B, None, None], q)
             if mul is None else mul(w, B, 2 * B))
        x = torch.stack([modadd(u, v, q), modsub(u, v, q)], dim=-3)
        x = x.view(*lead, n, m)
    return x


def _gs_stages(x: torch.Tensor, itw: torch.Tensor, q: torch.Tensor):
    """GS inverse butterflies along axis -2 (no 1/n factor); shapes as
    _ct_stages'."""
    *lead, n, m = x.shape
    for s in range(n.bit_length() - 2, -1, -1):
        B, H = 1 << s, n >> (s + 1)
        u, v = x.reshape(*lead, B, 2, H, m).unbind(-3)
        s1 = mulmod(modsub(u, v, q), itw[..., B: 2 * B, None, None], q)
        x = torch.stack([modadd(u, v, q), s1], dim=-3).view(*lead, n, m)
    return x


def _rep_rows(nb: NttBasis, rep: int) -> torch.Tensor:
    """Basis row of each of rep stacked copies' limbs: i % M."""
    M = nb.q.shape[0]
    return torch.arange(rep * M, device=nb.q.device) % M


def _packed_rows(nb: NttBasis, rep: int) -> torch.Tensor:
    """Basis row of each limb of rep stacked lane-packed copies, G*k limbs
    a copy (G = ceil(M/k)): min(i, M - 1) within a copy, so the padding
    limbs read the last row's tables, as their data is the last row's."""
    M, k = nb.q.shape[0], nb.pack
    G = -(-M // k)
    return torch.arange(G * k, device=nb.q.device).clamp(max=M - 1).repeat(rep)


def _tables(nb: NttBasis, rows: torch.Tensor, *names):
    return [getattr(nb, k).long()[rows] for k in names]


def _basis(nb: NttBasis, *names):
    """The basis tables `names` as int64, once each: [M, ...] against the
    [rep, M, ...] view of rep stacked copies (no per-copy gather)."""
    return [getattr(nb, k).long() for k in names]


def _ntt(x, nb, rep):
    M = nb.q.shape[0]
    q, tw1, mid, tw2 = _basis(nb, "q", "tw1", "mid", "tw2")
    q4 = q.view(M, 1, 1, 1)
    y = _ct_stages(x.long().view((rep, M) + x.shape[1:]), tw1, q4)
    y = mulmod(y, mid, q4[:, 0])
    y = _ct_stages(y.transpose(-1, -2).contiguous(), tw2, q4)
    return y.view((rep * M,) + y.shape[2:]).to(torch.int32)


def _intt(x, nb, rep):
    M = nb.q.shape[0]
    q, itw2, mid_inv, itw1 = _basis(nb, "q", "itw2", "mid_inv", "itw1")
    q4 = q.view(M, 1, 1, 1)
    y = _gs_stages(x.long().view((rep, M) + x.shape[1:]), itw2, q4)
    y = mulmod(y.transpose(-1, -2), mid_inv, q4[:, 0])
    y = _gs_stages(y.contiguous(), itw1, q4)
    return y.view((rep * M,) + y.shape[2:]).to(torch.int32)


def _phase1(x, nb, rows):
    q, tw1, mid = _tables(nb, rows, "q", "tw1", "mid")
    q4 = q.view(-1, 1, 1, 1)
    y = _ct_stages(x.long(), tw1, q4)
    return mulmod(y, mid, q4[:, 0]).to(torch.int32)


def _phase2(x, nb, rows):
    q, tw2 = _tables(nb, rows, "q", "tw2")
    return _ct_stages(x.long(), tw2, q.view(-1, 1, 1, 1)).to(torch.int32)


def _iphase2(x, nb, rows):
    q, itw2 = _tables(nb, rows, "q", "itw2")
    return _gs_stages(x.long(), itw2, q.view(-1, 1, 1, 1)).to(torch.int32)


def _iphase1(x, nb, rows):
    q, mid_inv, itw1 = _tables(nb, rows, "q", "mid_inv", "itw1")
    q4 = q.view(-1, 1, 1, 1)
    y = mulmod(x, mid_inv, q4[:, 0])
    return _gs_stages(y, itw1, q4).to(torch.int32)


def ntt_plain(x: torch.Tensor, nb: NttBasis, rep: int = 1) -> torch.Tensor:
    """Plain version of kernel B1: int32 [rep*M, n1, n2] -> [rep*M, n2, n1]
    (the basis tables broadcast over the rep copies)."""
    return _ntt(x, nb, rep)


def intt_plain(x: torch.Tensor, nb: NttBasis, rep: int = 1) -> torch.Tensor:
    """Plain version of kernel B2: int32 [rep*M, n2, n1] -> [rep*M, n1, n2]
    (the basis tables broadcast over the rep copies)."""
    return _intt(x, nb, rep)


def ntt_phase1_plain(x: torch.Tensor, nb: NttBasis,
                     rep: int = 1) -> torch.Tensor:
    """Plain version of kernel B6: stage-1 CT butterflies along n1, then
    times the mid slice. int32 [rep*M, n1, c] coeff columns -> [rep*M, n1,
    c] in [0, q); nb.mid is [M, n1, c]."""
    return _phase1(x, nb, _rep_rows(nb, rep))


def ntt_phase2_plain(x: torch.Tensor, nb: NttBasis,
                     rep: int = 1) -> torch.Tensor:
    """Plain version of kernel B7: stage-2 CT butterflies along n2.
    int32 [rep*M, n2, c] -> [rep*M, n2, c] eval columns in [0, q)."""
    return _phase2(x, nb, _rep_rows(nb, rep))


def intt_phase2_plain(x: torch.Tensor, nb: NttBasis,
                      rep: int = 1) -> torch.Tensor:
    """Plain version of kernel B8: inverse stage-2 GS butterflies along n2.
    int32 [rep*M, n2, c] eval columns -> [rep*M, n2, c] in [0, q)."""
    return _iphase2(x, nb, _rep_rows(nb, rep))


def intt_phase1_plain(x: torch.Tensor, nb: NttBasis,
                      rep: int = 1) -> torch.Tensor:
    """Plain version of kernel B9: times the mid_inv slice (carries 1/N),
    then inverse stage-1 GS butterflies along n1. int32 [rep*M, n1, c] ->
    [rep*M, n1, c] coeff columns in [0, q); nb.mid_inv is [M, n1, c]."""
    return _iphase1(x, nb, _rep_rows(nb, rep))


# ---- lane packing (B10-B13) ------------------------------------------------
def pack_limb_lanes(x: torch.Tensor, k: int) -> torch.Tensor:
    """[M, n, c] -> [M/k, n, k*c]: lane block j of group g holds limb
    g*k + j's c columns (`homulator_tpu/ops/ntt_pallas.py::pack_limb_lanes`)."""
    M, n, c = x.shape
    return x.reshape(M // k, k, n, c).transpose(1, 2).reshape(M // k, n, k * c)


def unpack_limb_lanes(y: torch.Tensor, k: int, c: int) -> torch.Tensor:
    """Inverse of pack_limb_lanes: [G, n, k*c] -> [G*k, n, c]."""
    G, n, _ = y.shape
    return y.reshape(G, n, k, c).transpose(1, 2).reshape(G * k, n, c)


def _pack_pad(x: torch.Tensor, k: int, rep: int = 1) -> torch.Tensor:
    """rep stacked copies [rep*M, n, c] -> [rep*G, n, k*c], G = ceil(M/k):
    each copy's rows padded to G*k with copies of its last row, then
    lane-packed (`homulator_tpu/ops/ntt.py::_pack_pad` on each copy, as the
    JAX package calls the sharded transform once a copy)."""
    R, n, c = x.shape
    M = R // rep
    G = -(-M // k)
    if G * k != M:
        idx = torch.arange(G * k, device=x.device).clamp(max=M - 1)
        x = x.reshape(rep, M, n, c).index_select(1, idx).view(rep * G * k, n, c)
    return pack_limb_lanes(x, k)


def _unpack_unpad(y: torch.Tensor, k: int, M: int, rep: int) -> torch.Tensor:
    """Inverse of _pack_pad: [rep*G, n, k*c] -> [rep*M, n, c], the padding
    rows dropped."""
    G, n, m = y.shape
    z = unpack_limb_lanes(y, k, m // k).view(rep, G // rep * k, n, m // k)
    return z[:, :M].reshape(rep * M, n, m // k)


def _packed_plain(phase, doc: str):
    def plain(x: torch.Tensor, nb: NttBasis, rep: int = 1) -> torch.Tensor:
        k = nb.pack
        y = phase(unpack_limb_lanes(x, k, x.shape[2] // k), nb,
                  _packed_rows(nb, rep))
        return pack_limb_lanes(y, k)
    plain.__doc__ = doc
    return plain


_PACKED_DOC = """Plain version of kernel {b}: {what} on rep stacked copies of
    lane-packed groups, int32 [rep*G, n, k*c] (G = ceil(M/k) a copy, k =
    nb.pack) -> the same layout in [0, q) per lane: unpacked, the per-limb
    plain phase with each limb's tables (the padding limbs the last row's),
    repacked."""
ntt_phase1_packed_plain = _packed_plain(_phase1, _PACKED_DOC.format(
    b="B10", what="stage-1 CT butterflies times the mid slice"))
ntt_phase2_packed_plain = _packed_plain(_phase2, _PACKED_DOC.format(
    b="B11", what="stage-2 CT butterflies"))
intt_phase2_packed_plain = _packed_plain(_iphase2, _PACKED_DOC.format(
    b="B12", what="inverse stage-2 GS butterflies"))
intt_phase1_packed_plain = _packed_plain(_iphase1, _PACKED_DOC.format(
    b="B13", what="the mid_inv slice product and inverse stage-1 GS "
    "butterflies"))


def _check_device(x: torch.Tensor):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _dispatch(name: str, plain):
    """A transform that runs kernel `name` (ntt_kernels) on a CUDA tensor
    and plain on a CPU tensor, as the kernel in the byte count of
    kernels.as_kernel."""
    kernel = getattr(ntt_kernels, name)

    def run(x: torch.Tensor, nb: NttBasis, rep: int = 1) -> torch.Tensor:
        _check_device(x)
        if x.is_cuda:
            with kernels.unobserved():
                return kernel(x, nb, rep)
        with kernels.as_kernel(*ntt_kernels.traffic(name, x, nb)):
            return plain(x, nb, rep)
    run.__doc__ = plain.__doc__
    return run


_ntt_fwd = _dispatch("ntt_fwd", ntt_plain)
_ntt_inv = _dispatch("ntt_inv", intt_plain)
ntt_phase1 = _dispatch("ntt_phase1", ntt_phase1_plain)
ntt_phase2 = _dispatch("ntt_phase2", ntt_phase2_plain)
intt_phase2 = _dispatch("intt_phase2", intt_phase2_plain)
intt_phase1 = _dispatch("intt_phase1", intt_phase1_plain)
ntt_phase1_packed = _dispatch("ntt_phase1_packed", ntt_phase1_packed_plain)
ntt_phase2_packed = _dispatch("ntt_phase2_packed", ntt_phase2_packed_plain)
intt_phase2_packed = _dispatch("intt_phase2_packed", intt_phase2_packed_plain)
intt_phase1_packed = _dispatch("intt_phase1_packed", intt_phase1_packed_plain)


def _comm_of(nb: NttBasis):
    comm = comm_mod.current()
    if (comm.rank, comm.size) != nb.shard:
        raise ValueError(f"basis sharded as {nb.shard} (rank, ns) run by "
                         f"rank {comm.rank} of {comm.size}")
    return comm


def _transpose_a2a(y: torch.Tensor, nb: NttBasis) -> torch.Tensor:
    """The distributed tile transpose: y is this shard's column slice
    [R, a, b/ns] of a global [R, a, b]; returns its slice [R, b, a/ns] of
    the global transpose. One all_to_all (row chunk i to rank i, received
    blocks concatenated in rank order along the columns) and a local
    transpose, made contiguous for the next phase kernel."""
    return _comm_of(nb).all_to_all(y, 1, 2).transpose(1, 2).contiguous()


def _packed_transpose_a2a(y: torch.Tensor, nb: NttBasis) -> torch.Tensor:
    """_transpose_a2a on lane-packed groups: y [G, a, k*cb] (cb = b/ns)
    -> [G, b, k*(a/ns)], still packed limb-major. One all_to_all, then
    the [G, a/ns, ns, k, cb] -> (0, 2, 4, 3, 1) relayout
    (`homulator_tpu/ops/ntt.py::_packed_transpose_a2a`)."""
    comm = _comm_of(nb)
    G, a, m = y.shape
    k, ns = nb.pack, comm.size
    z = comm.all_to_all(y, 1, 2).view(G, a // ns, ns, k, m // k)
    return z.permute(0, 2, 4, 3, 1).reshape(G, ns * (m // k), k * (a // ns))


def ntt_rep(x: torch.Tensor, nb: NttBasis, rep: int) -> torch.Tensor:
    """Forward NTT of rep stacked copies over one basis:
    [rep*M, n1, n2] -> [rep*M, n2, n1] int32 (sharded: [rep*M, n1, n2/ns]
    coeff columns -> [rep*M, n2, n1/ns] eval columns)."""
    _check_device(x)
    if nb.pack:
        y = ntt_phase1_packed(_pack_pad(x, nb.pack, rep), nb, rep)
        y = ntt_phase2_packed(_packed_transpose_a2a(y, nb), nb, rep)
        return _unpack_unpad(y, nb.pack, nb.q.shape[0], rep)
    if nb.shard is not None:
        y = _transpose_a2a(ntt_phase1(x, nb, rep), nb)
        return ntt_phase2(y, nb, rep)
    return _ntt_fwd(x, nb, rep)


def intt_rep(x: torch.Tensor, nb: NttBasis, rep: int) -> torch.Tensor:
    """Inverse of ntt_rep: [rep*M, n2, n1] -> [rep*M, n1, n2] int32
    (sharded: [rep*M, n2, n1/ns] -> [rep*M, n1, n2/ns])."""
    _check_device(x)
    if nb.pack:
        y = intt_phase2_packed(_pack_pad(x, nb.pack, rep), nb, rep)
        y = intt_phase1_packed(_packed_transpose_a2a(y, nb), nb, rep)
        return _unpack_unpad(y, nb.pack, nb.q.shape[0], rep)
    if nb.shard is not None:
        y = _transpose_a2a(intt_phase2(x, nb, rep), nb)
        return intt_phase1(y, nb, rep)
    return _ntt_inv(x, nb, rep)


def ntt(x: torch.Tensor, nb: NttBasis) -> torch.Tensor:
    """[M, n1, n2] coeff tiles -> [M, n2, n1] eval tiles."""
    return ntt_rep(x, nb, 1)


def intt(x: torch.Tensor, nb: NttBasis) -> torch.Tensor:
    """[M, n2, n1] eval tiles -> [M, n1, n2] coeff tiles."""
    return intt_rep(x, nb, 1)
