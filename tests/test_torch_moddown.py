"""Kernels B19-B21, ModDown's elementwise steps (`ops/moddown.py`,
csrc/moddown.cu), bit for bit (tolerance 0):

  * an int64 model of each kernel, step by step as csrc/moddown.cu
    computes it on uint32 (lazy Shoup products in [0, 2q), the q_last sum
    kept below 2 q_last, every sum below 4q < 2^32), each margin
    asserted, equals its plain version, at set-B and set-C key-switch
    tables at N = 2^8, with and without a batch, on random inputs, on
    every input q - 1 and on inputs placed at both centering boundaries
    (md_head's count v: bhat = p_j >> 1 and (p_j >> 1) + 1; its
    indicator: w = q_last >> 1 and (q_last >> 1) + 1);
  * the route on the models, and on the plain versions (the CPU's route),
    equals the int64 route it replaced (the torch ops moddown_rescale2
    and _moddown ran before, below as `_int64_rescale2` and
    `_int64_moddown`), word for word, and the whole hmult and rotation
    equal the host engine (RefCkks);
  * the wrappers refuse CPU tensors and shapes the kernels do not take.

Imports no JAX: the `card` test runs on a CUDA GPU with
`python -m pytest --noconftest -m card tests/test_torch_moddown.py` (the
conftest imports JAX) and skips here.
"""

import numpy as np
import pytest
import torch

from homulator_tpu_torch import api, kernels
from homulator_tpu_torch.api import CkksEngine, get_params
from homulator_tpu_torch.context import Ciphertext, DeviceContext
from homulator_tpu_torch.ops import keyswitch as ks
from homulator_tpu_torch.ops import moddown as md
from homulator_tpu_torch.ops.bconv_fused import bconv_fused
from homulator_tpu_torch.ops.keyswitch import _over_rows
from homulator_tpu_torch.ops.modmath import (
    lazy_tree_sum, modadd, modsub, shoup_mul,
)
from homulator_tpu_torch.ops.ntt import intt_rep, ntt_rep

SCALE = 2.0 ** 26
# (n, maxLevel, alpha, level): set B's and set C's limb structures at N =
# 2^8 (a last digit of 5 rows at set B, 4 full digits at set C), and a
# rotation's level below set B's
SETS = {"B": (256, 45, 15, 35), "C": (256, 24, 6, 24),
        "B level 30": (256, 45, 15, 30)}
U32 = 1 << 32


@pytest.fixture(scope="module", params=list(SETS))
def case(request):
    n, max_level, alpha, level = SETS[request.param]
    dc = DeviceContext(get_params(n, max_level, alpha), "cpu")
    return dc, dc.keyswitch_tables(level)


# ---- the int64 route the kernels replaced --------------------------------

def _c2(v):
    return v.long().view(1, -1, 1, 1)


def _int64_moddown(accs, kt):
    """keyswitch._moddown before kernels B19-B21."""
    rep = len(accs)
    sp = torch.stack([a[0] for a in accs], dim=-4).to(torch.int32)
    b = _over_rows(intt_rep, sp, kt.special_nt)
    convs = [bconv_fused(b[..., k, :, :, :], kt.md_s1, kt.md_s1_sh,
                         kt.special_nt.q, kt.md_mat, kt.md_mma,
                         kt.md_horner_sh, kt.main_nt.q, center=True)
             for k in range(rep)]
    ce = _over_rows(ntt_rep, torch.stack(convs, dim=-4), kt.main_nt)
    mq = _c2(kt.main_nt.q)
    diff = modsub(torch.stack([a[1] for a in accs], dim=-4), ce, mq)
    return shoup_mul(diff, _c2(kt.pinv), _c2(kt.pinv_sh), mq).to(torch.int32)


def _int64_rescale2(acc0, acc1, d0, d1, kt):
    """keyswitch.moddown_rescale2 before kernels B19-B21."""
    tt, lm1 = kt.tail, kt.level - 1
    sp_q = _c2(kt.special_nt.q)
    b = _over_rows(intt_rep, torch.stack([acc0[0], acc1[0]], dim=-4)
                   .to(torch.int32), kt.special_nt)
    bhat = shoup_mul(b, _c2(kt.md_s1), _c2(kt.md_s1_sh), sp_q)
    v_b = (bhat >= (sp_q >> 1) + 1).sum(dim=-3, keepdim=True)
    bhat_ext = torch.cat([bhat, v_b], dim=-3)
    q_last = kt.main_nt.q[lm1].long()
    terms = shoup_mul(bhat_ext, _c2(tt.md2_last), _c2(tt.md2_last_sh),
                      q_last)
    conv_last = lazy_tree_sum(terms.movedim(-3, 0), q_last)
    acc_main = torch.stack([acc0[1], acc1[1]], dim=-4)
    dd = torch.stack([d0, d1], dim=-4)
    zl_eval = modadd(acc_main[..., lm1, :, :],
                     shoup_mul(dd[..., lm1, :, :], tt.p_modq[lm1].long(),
                               tt.p_modq_sh[lm1], q_last), q_last)
    zl_coeff = _over_rows(intt_rep, zl_eval.to(torch.int32).unsqueeze(-3),
                          tt.last_nt).squeeze(-3)
    w = shoup_mul(modsub(zl_coeff, conv_last, q_last), kt.pinv[lm1].long(),
                  kt.pinv_sh[lm1], q_last)
    ind_w = (w >= (q_last >> 1) + 1).long()
    convs = [bconv_fused(
        torch.cat([bhat_ext[..., k, :, :, :], w[..., k, None, :, :],
                   ind_w[..., k, None, :, :]], dim=-3).to(torch.int32),
        tt.one, tt.one_sh, tt.in_q, tt.mat, tt.mma, tt.horner_sh,
        tt.out_nt.q) for k in (0, 1)]
    e = _over_rows(ntt_rep, torch.stack(convs, dim=-4), tt.out_nt)
    oq = _c2(tt.out_nt.q)
    z = modadd(acc_main[..., :lm1, :, :],
               shoup_mul(dd[..., :lm1, :, :], _c2(tt.p_modq[:lm1]),
                         _c2(tt.p_modq_sh[:lm1]), oq), oq)
    return shoup_mul(modsub(z, e, oq), _c2(tt.pq_inv), _c2(tt.pq_inv_sh),
                     oq).to(torch.int32)


# ---- int64 models of the kernels' uint32 arithmetic ----------------------

def _u(v):
    """A table's words as exact non-negative integers (int64)."""
    return v.long() & (U32 - 1)


def _below(x, bound, what):
    assert bool((x >= 0).all()) and bool((x < bound).all()), what


def _csub(a, m):
    return torch.where(a >= m, a - m, a)


def _shoup_lazy(a, w, w_sh, q):
    """modarith.cuh::shoup_mul_lazy on exact integers: a any uint32, w <
    q; the high word floor(a * w_sh / 2^32) from 16-bit halves of a (no
    int64 product wraps); the result, which uint32 holds exactly, in [0,
    2q)."""
    _below(a, U32, "Shoup input above uint32")
    _below(w, q, "Shoup factor not below q")
    hi = ((a >> 16) * w_sh + (((a & 0xFFFF) * w_sh) >> 16)) >> 16
    r = a * w - hi * q
    _below(r, 2 * q, "lazy Shoup product outside [0, 2q)")
    return r


def _shoup(a, w, w_sh, q):
    return _csub(_shoup_lazy(a, w, w_sh, q), q)


def _add(a, b, bound):
    """A uint32 sum, asserted below `bound` (<= 4q < 2^32)."""
    s = a + b
    _below(s, bound, "sum above its lazy range")
    assert bool((bound <= U32).all() if torch.is_tensor(bound)
                else bound <= U32)
    return s


def zl_model(acc0, acc1, d0, d1, kt):
    """md_zl_kernel: each (b, k) row's words."""
    lm1, tt = kt.level - 1, kt.tail
    ql = _u(kt.main_nt.q[lm1])
    m, m_sh = _u(tt.p_modq[lm1]), _u(tt.p_modq_sh[lm1])
    out = []
    for a, d in ((acc0, d0), (acc1, d1)):
        a, d = a[..., lm1, :, :].long(), d[..., lm1, :, :].long()
        _below(a, ql, "acc not canonical")
        _below(d, ql, "d not canonical")
        out.append(_csub(_add(a, _shoup(d, m, m_sh, ql), 2 * ql), ql))
    return torch.stack(out, dim=-3).to(torch.int32)


def head_model(b, zl, kt):
    """md_head_kernel: per (b, k) and word, the loop over the alpha special
    rows (bhat, the count, the lazy q_last sum), then w and its
    indicator."""
    lm1, tt = kt.level - 1, kt.tail
    alpha = kt.special_nt.q.shape[0]
    ql = _u(kt.main_nt.q[lm1])
    m2, m2_sh = _u(tt.md2_last), _u(tt.md2_last_sh)
    rows = []
    v = torch.zeros_like(zl, dtype=torch.int64)
    conv = torch.zeros_like(v)
    for j in range(alpha):
        p = _u(kt.special_nt.q[j])
        x = b[..., j, :, :].long()
        _below(x, p, "B2 output not canonical")
        bh = _shoup(x, _u(kt.md_s1[j]), _u(kt.md_s1_sh[j]), p)
        v = v + (bh >= (p >> 1) + 1).long()
        conv = _csub(_add(conv, _shoup_lazy(bh, m2[j], m2_sh[j], ql),
                          4 * ql), 2 * ql)
        rows.append(bh)
    _below(v, alpha + 1, "count above alpha")
    rows.append(v)
    cv = _csub(_csub(_add(conv, _shoup_lazy(v, m2[alpha], m2_sh[alpha], ql),
                          4 * ql), 2 * ql), ql)
    z = zl.long()
    _below(z, ql, "zl not canonical")
    w = _shoup(_add(z + ql, -cv, 2 * ql), _u(kt.pinv[lm1]),
               _u(kt.pinv_sh[lm1]), ql)
    rows += [w, (w >= (ql >> 1) + 1).long()]
    return torch.stack(rows, dim=-3).to(torch.int32)


def tail_model(mains, e, q, c, c_sh, ds=None, pm=None, pm_sh=None):
    """md_tail_kernel: per element, row and word."""
    rows = e.shape[-3]
    qc = _u(q).view(-1, 1, 1)
    a = torch.stack([m[..., :rows, :, :].long() for m in mains], dim=-4)
    _below(a, qc, "acc not canonical")
    if ds is not None:
        d = torch.stack([x[..., :rows, :, :].long() for x in ds], dim=-4)
        _below(d, qc, "d not canonical")
        t = _shoup(d, _u(pm[:rows]).view(-1, 1, 1),
                   _u(pm_sh[:rows]).view(-1, 1, 1), qc)
        a = _csub(_add(a, t, 2 * qc), qc)
    ev = e.long()
    _below(ev, qc, "B1 output not canonical")
    return _shoup(_add(a + qc, -ev, 2 * qc), _u(c).view(-1, 1, 1),
                  _u(c_sh).view(-1, 1, 1), qc).to(torch.int32)


# ---- inputs ---------------------------------------------------------------

def _residues(rng, q, shape, worst):
    """int32 words below q[i] along axis -3 (or all q - 1)."""
    q = np.asarray(q.cpu(), dtype=np.int64).reshape(-1, 1, 1)
    full = np.broadcast_to(q, shape[:-3] + q.shape[:1] + shape[-2:])
    x = full - 1 if worst else rng.integers(0, full)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


def _accs(kt, batch, worst, seed):
    """One key switch's accumulators as B18 returns them (int32 views of
    one [B, 2, alpha+level, R, C] tensor, per k the pair (sp, main)) and
    the tensor product's d0, d1 (int64 [B, level, R, C])."""
    rng = np.random.default_rng(seed)
    alpha = kt.special_nt.q.shape[0]
    n1, n2 = kt.main_nt.n1, kt.main_nt.n2
    lead = () if batch is None else (batch,)
    acc = _residues(rng, kt.ext_nt.q, lead + (2, kt.ext_nt.q.shape[0], n2, n1),
                    worst)
    d = [_residues(rng, kt.main_nt.q, lead + (kt.level, n2, n1), worst).long()
         for _ in (0, 1)]
    pairs = [(acc[..., k, :alpha, :, :], acc[..., k, alpha:, :, :])
             for k in (0, 1)]
    return pairs, d


# ---- the tests -------------------------------------------------------------

@pytest.mark.parametrize("worst", [False, True], ids=["random", "q-1"])
@pytest.mark.parametrize("batch", [None, 1, 2], ids=["one", "B1", "B2"])
def test_models_equal_plain(case, batch, worst):
    """Each kernel's model == its plain version, and both routes == the
    int64 route, on the key switch's own intermediates."""
    dc, kt = case
    (acc0, acc1), (d0, d1) = _accs(kt, batch, worst, kt.level)
    zl = md.zl_plain(acc0[1], acc1[1], d0, d1, kt)
    assert torch.equal(zl_model(acc0[1], acc1[1], d0, d1, kt), zl)
    b = _over_rows(intt_rep, torch.stack([acc0[0], acc1[0]], dim=-4),
                   kt.special_nt)
    zlc = _over_rows(intt_rep, zl.unsqueeze(-3), kt.tail.last_nt).squeeze(-3)
    head = md.head_plain(b, zlc, kt)
    assert torch.equal(head_model(b, zlc, kt), head)
    lm1 = kt.level - 1
    tt = kt.tail
    e = _residues(np.random.default_rng(1), tt.out_nt.q,
                  b.shape[:-3] + (lm1,) + zl.shape[-2:], worst)
    args = ((acc0[1], acc1[1]), e, tt.out_nt.q, tt.pq_inv, tt.pq_inv_sh,
            (d0, d1), tt.p_modq, tt.p_modq_sh)
    assert torch.equal(tail_model(*args), md.tail_plain(*args))
    ce = _residues(np.random.default_rng(2), kt.main_nt.q,
                   b.shape[:-3] + (kt.level,) + zl.shape[-2:], worst)
    args = ((acc0[1], acc1[1]), ce, kt.main_nt.q, kt.pinv, kt.pinv_sh)
    assert torch.equal(tail_model(*args), md.tail_plain(*args))
    args = ((acc0[1],), ce[..., :1, :, :, :], kt.main_nt.q, kt.pinv,
            kt.pinv_sh)
    assert torch.equal(tail_model(*args), md.tail_plain(*args))


def _on_models(monkeypatch):
    """Route keyswitch's ModDown through the kernels' models."""
    monkeypatch.setattr(ks, "md_zl", zl_model)
    monkeypatch.setattr(ks, "md_head", head_model)
    monkeypatch.setattr(ks, "md_tail", tail_model)


@pytest.mark.parametrize("models", [False, True], ids=["plain", "models"])
@pytest.mark.parametrize("worst", [False, True], ids=["random", "q-1"])
@pytest.mark.parametrize("batch", [None, 2], ids=["one", "B2"])
def test_route_equals_the_int64_route(case, batch, worst, models,
                                      monkeypatch):
    dc, kt = case
    if models:
        _on_models(monkeypatch)
    (acc0, acc1), (d0, d1) = _accs(kt, batch, worst, kt.level + 1)
    got = ks.moddown_rescale2(acc0, acc1, d0, d1, kt)
    lead = () if batch is None else (batch,)
    assert got.shape == lead + (2, kt.level - 1) + d0.shape[-2:]
    assert got.dtype == torch.int32
    assert torch.equal(got, _int64_rescale2(acc0, acc1, d0, d1, kt))
    pair = ks.moddown_pair2(acc0, acc1, kt)
    assert pair.shape == lead + (2, kt.level) + d0.shape[-2:]
    assert torch.equal(pair, _int64_moddown([acc0, acc1], kt))
    assert torch.equal(ks._moddown([acc1], kt), _int64_moddown([acc1], kt))


def test_centering_boundaries(case):
    """md_head's two centerings at their boundaries: bhat_j set to p_j >>
    1 (not counted) and (p_j >> 1) + 1 (counted) in the first words of
    row j, and w to q_last >> 1 and (q_last >> 1) + 1 (indicator 0, 1);
    the model, the plain version and the old route's rows agree."""
    dc, kt = case
    alpha = kt.special_nt.q.shape[0]
    lm1, tt = kt.level - 1, kt.tail
    (acc0, acc1), _ = _accs(kt, 2, False, 5)
    b = _over_rows(intt_rep, torch.stack([acc0[0], acc1[0]], dim=-4),
                   kt.special_nt).clone()
    for j in range(alpha):  # b_j = target * s1_j^{-1} mod p_j
        p = int(kt.special_nt.q[j])
        inv = pow(int(kt.md_s1[j]) & (U32 - 1), -1, p)
        for i, t in enumerate((p >> 1, (p >> 1) + 1)):
            b[..., j, 0, i] = t * inv % p
            b[..., j, 0, 2 + i] = (p - 1) * inv % p
    ql = int(kt.main_nt.q[lm1])
    zl = _residues(np.random.default_rng(6), kt.main_nt.q[lm1:],
                   b.shape[:-4] + (2, 1) + b.shape[-2:], False).squeeze(-3)
    zl = zl.contiguous()
    # w = (zl - conv) * P^{-1}: zl = target * P + conv mod q_last
    rows = md.head_plain(b, zl, kt).long()
    conv = (zl.long() - rows[..., alpha + 1, :, :]
            * int(tt.p_modq[lm1])) % ql
    for i, t in enumerate((ql >> 1, (ql >> 1) + 1)):
        zl[..., 1, 4 + i] = (t * int(tt.p_modq[lm1]) + conv[..., 1, 4 + i]) \
            % ql
    got = head_model(b, zl, kt)
    assert torch.equal(got, md.head_plain(b, zl, kt))
    v = got[..., alpha, :, :]
    for j in range(alpha):
        assert bool((got[..., j, 0, 0] == int(kt.special_nt.q[j]) >> 1).all())
        assert bool((got[..., j, 0, 1] == (int(kt.special_nt.q[j]) >> 1)
                     + 1).all())
    assert bool((v[..., 0, 0] == 0).all()) and bool((v[..., 0, 1] ==
                                                      alpha).all())
    assert bool((v[..., 0, 2] == alpha).all())
    assert bool((got[..., alpha + 1, 1, 4] == ql >> 1).all())
    assert bool((got[..., alpha + 1, 1, 5] == (ql >> 1) + 1).all())
    assert bool((got[..., alpha + 2, 1, 4] == 0).all())
    assert bool((got[..., alpha + 2, 1, 5] == 1).all())


@pytest.fixture(scope="module")
def eng():
    e = CkksEngine(get_params(256, 8, 4, 26), 7, device="cpu")
    e.keygen()
    return e


@pytest.mark.parametrize("op", ["hmult", "hsquare", "hrotate", "hoisted"])
def test_engine_on_the_models_equals_ref(eng, op, monkeypatch):
    """The engine's ops with ModDown on the kernels' models == the exact
    host engine, on the piecewise and the fused route."""
    _on_models(monkeypatch)
    rng = np.random.default_rng(3)
    a, b = (eng.encrypt_complex(rng.normal(size=128), 6, SCALE)
            for _ in range(2))
    ra, rb = eng.to_ref(a), eng.to_ref(b)
    for fused in (False, True):
        monkeypatch.setattr(api, "USE_FUSED_HPIP", fused)
        if op == "hoisted":
            got = eng.hrotate_hoisted(a, [1, 2])
            for g, s in zip(got, (1, 2)):
                assert np.array_equal(eng.dc.download(g.data),
                                      eng.ref.hrotate(ra, s).data)
            continue
        got, want = {
            "hmult": (lambda: eng.hmult(a, b), lambda: eng.ref.hmult(ra, rb)),
            "hsquare": (lambda: eng.hsquare(a),
                        lambda: eng.ref.hmult(ra, ra)),
            "hrotate": (lambda: eng.hrotate(a, 1),
                        lambda: eng.ref.hrotate(ra, 1)),
        }[op]
        assert np.array_equal(eng.dc.download(got().data), want().data)


def test_kernels_refuse_what_they_do_not_take():
    dc = DeviceContext(get_params(64, 6, 2), "cpu")
    kt = dc.keyswitch_tables(6)
    (acc0, acc1), (d0, d1) = _accs(kt, None, False, 1)
    with pytest.raises(ValueError, match="CUDA kernel"):
        md.zl_kernel(acc0[1], acc1[1], d0, d1, kt)
    with pytest.raises(ValueError, match="shape"):
        md.zl_kernel(acc0[1][:3], acc1[1], d0, d1, kt)
    b = torch.zeros((2, 2) + acc0[0].shape[-2:], dtype=torch.int32)
    zl = torch.zeros((2,) + acc0[0].shape[-2:], dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        md.head_kernel(torch.zeros((2, 3) + b.shape[-2:], dtype=torch.int32),
                       zl, kt)
    with pytest.raises(TypeError, match="dtype"):
        md.head_kernel(b, zl.long(), kt)
    e = torch.zeros((2, 6) + acc0[0].shape[-2:], dtype=torch.int32)
    with pytest.raises(ValueError, match="1 or 2"):
        md.tail_kernel([acc0[1]] * 3, e, kt.main_nt.q, kt.pinv, kt.pinv_sh)
    with pytest.raises(ValueError, match="CUDA kernel"):
        md.tail_kernel([acc0[1], acc1[1]], e, kt.main_nt.q, kt.pinv,
                       kt.pinv_sh)
    odd = torch.zeros((2, 6, 3, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 4"):
        md.tail_kernel([odd[0], odd[1]], odd, kt.main_nt.q, kt.pinv,
                       kt.pinv_sh)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: kernels B19-B21 run only on the card")


def _to(pairs, d, dev):
    return ([tuple(t.to(dev) for t in p) for p in pairs],
            [t.to(dev) for t in d])


@pytest.mark.card
def test_kernels_on_the_card(card):
    """On a CUDA GPU at the cells' shapes (N = 2^16): the ModDown +
    rescale at set B level 35 (B = 1 and 8, and all q - 1) and set C level
    24 (B = 8), the ModDown pair at set B level 34 (B = 8), level 30 (B =
    1) and in the worst case: each route on the card == the same route on
    the CPU (plain versions), launching kernels.LAUNCHES["moddown"] three
    times (rescale) or once (pair). Each kernel on a 4-way column slice
    ([R, C/4] tiles, a coefficient-sharded shard's) == its plain version.
    Then the engine at N = 2^13 on the card == the CPU, with its
    decrypts."""
    dcs = {}
    for name, level, batch, worst, what in (
            ("B", 35, 1, False, "rescale"), ("B", 35, 8, False, "rescale"),
            ("B", 35, 1, True, "rescale"), ("C", 24, 8, False, "rescale"),
            ("B", 34, 8, False, "pair"), ("B", 30, 1, False, "pair"),
            ("B", 35, 2, True, "pair")):
        if name not in dcs:
            p = get_params(*{"B": (1 << 16, 45, 15),
                             "C": (1 << 16, 24, 6)}[name])
            dcs[name] = (DeviceContext(p, "cuda"), DeviceContext(p, "cpu"))
        gpu, cpu = (dc.keyswitch_tables(level) for dc in dcs[name])
        pairs, d = _accs(cpu, batch, worst, level)
        gp, gd = _to(pairs, d, "cuda")
        kernels.reset_launch_counts()
        if what == "pair":
            got = ks.moddown_pair2(*gp, gpu)
            want = ks.moddown_pair2(*pairs, cpu)
        else:
            got = ks.moddown_rescale2(*gp, *gd, gpu)
            want = ks.moddown_rescale2(*pairs, *d, cpu)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["moddown"] == (1 if what == "pair" else 3)
        assert torch.equal(got.cpu(), want), (name, level, batch, worst, what)
    gpu, cpu = (dc.keyswitch_tables(35) for dc in dcs["B"])
    pairs, d = _accs(cpu, 2, False, 9)
    c = pairs[0][0].shape[-1] // 4
    pairs = [tuple(t[..., c:2 * c].contiguous() for t in p) for p in pairs]
    d = [t[..., c:2 * c].contiguous() for t in d]
    (g0, g1), gd = _to(pairs, d, "cuda")
    (a0, a1) = pairs
    zl = md.zl_plain(a0[1], a1[1], *d, cpu)
    assert torch.equal(md.zl_kernel(g0[1], g1[1], *gd, gpu).cpu(), zl)
    b = _residues(np.random.default_rng(3), cpu.special_nt.q,
                  (2, 2, cpu.special_nt.q.shape[0]) + zl.shape[-2:], False)
    assert torch.equal(md.head_kernel(b.cuda(), zl.cuda(), gpu).cpu(),
                       md.head_plain(b, zl, cpu))
    tt_c, tt_g = cpu.tail, gpu.tail
    e = _residues(np.random.default_rng(4), tt_c.out_nt.q,
                  (2, 2, 34) + zl.shape[-2:], False)
    want = md.tail_plain((a0[1], a1[1]), e, tt_c.out_nt.q, tt_c.pq_inv,
                         tt_c.pq_inv_sh, d, tt_c.p_modq, tt_c.p_modq_sh)
    got = md.tail_kernel((g0[1], g1[1]), e.cuda(), tt_g.out_nt.q,
                         tt_g.pq_inv, tt_g.pq_inv_sh, gd, tt_g.p_modq,
                         tt_g.p_modq_sh)
    assert torch.equal(got.cpu(), want)
    p = get_params(1 << 13, 8, 3)
    eng = CkksEngine(p, 7, device="cuda")
    eng.keygen()
    cpu_eng = CkksEngine(p, device="cpu")
    cpu_eng.ref = eng.ref
    rng = np.random.default_rng(1)
    v1, v2 = rng.normal(size=p.n // 2), rng.normal(size=p.n // 2)
    a, b = (eng.encrypt_complex(v, 8, SCALE) for v in (v1, v2))
    ac, bc = (Ciphertext(x.data.cpu(), x.level, x.scale) for x in (a, b))
    for op, run, gate in (
            ("hmult", lambda e, x, y: e.hmult(x, y), v1 * v2),
            ("hsquare", lambda e, x, y: e.hsquare(x), v1 * v1),
            ("hrotate", lambda e, x, y: e.hrotate(x, 1), np.roll(v1, -1))):
        got = run(eng, a, b)
        cpu_eng.relin_key = eng.relin_key.cpu()
        cpu_eng.rot_keys = {s: k.cpu() for s, k in eng.rot_keys.items()}
        assert torch.equal(got.data.cpu(), run(cpu_eng, ac, bc).data), op
        assert np.max(np.abs(eng.decrypt_complex(got) - gate)) < 1e-2, op
