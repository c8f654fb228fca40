"""Kernels B3, B5 and B17 (csrc/bconv.cu, csrc/bconv_mma.cu on the
tensor-core core of csrc/planes_mma.cuh) around what the CPU can run: a
plain int64 model of their schedule, bit for bit (tolerance 0) against the
plain versions `bconv_plain` / `bconv_step2_plain` /
`bconv_planes_mm_plain`, which tests/test_torch_bconv.py,
tests/test_torch_bconv_step2.py and tests/test_torch_anatomy.py hold
against the JAX package; B5's model also against the JAX
`bconv_step2_pallas` in interpret mode.

The model follows the kernels lane by lane: the table staged from
build_bf16_tables' mbig into the device layout (row (jb*4 + i)*8 + r, byte
4t + p), each warp tile's x rows staged (zero past ncoef, garbage in the
rows past the input's), step 1 and the centering count on the A fragments
with the quad's two xor shuffles, ldmatrix.x4's B fragments from the lane
addresses the kernel gives it, the m16n8k32 u8 product from the fragment
layouts of the PTX ISA, the C fragments, and the epilogue's fold and
reductions, with every exactness margin asserted as it is used: s32 plane
sums below 2^23, the folds below 2^31 (no uint32 wrap), each lazy Shoup
product in [0, 2q), their sum below 4q < 2^32. B5 is the same schedule
with step 1 and the count off: its rows (the count row last) enter the
product as they were staged. The worst case (every table byte and every
input byte 255, nd = 32, the largest primes below numtheory.PRIME_CAP)
runs through the same model. The port's bf16 tables equal the JAX
context's bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu.context import DeviceContext as JaxContext
from homulator_tpu.ops.bconv_pallas import bconv_step2_pallas
from homulator_tpu.params import get_params as jax_params
from homulator_tpu_torch import numtheory as nt
from homulator_tpu_torch.context import DeviceContext
from homulator_tpu_torch.ops.bconv import bconv_step2, bconv_step2_plain
from homulator_tpu_torch.ops.bconv_fused import (
    SMEM_LIMIT, bconv_plain, bconv_planes_mm_plain, build_bf16_tables,
    mma_smem_bytes, mma_table,
)
from homulator_tpu_torch.params import get_params

MASK = (1 << 32) - 1
LANE = np.arange(32)
G, TIG = LANE >> 2, LANE & 3
LEVEL = 5  # alpha 2: digits (0,2) (2,4) (4,5) -- the last one partial
# set B's conversions (nd table columns / 4, m_out), the smallest, and the
# largest the core takes
SHAPES = [(16, 35), (6, 45), (18, 34), (1, 1), (32, 64)]


def _geometry(nd, m_out):
    return -(-nd // 8), -(-m_out // 8)  # k32 steps, blocks of 8 outputs


def _bytes(w):
    """uint32 words (uint64 array) -> their four bytes, lowest first."""
    return (w[..., None] >> (np.uint64(8) * np.arange(4, dtype=np.uint64))
            ) & np.uint64(255)


def _pack(b):
    """(..., 4) bytes, lowest first -> uint32 words."""
    return sum(b[..., e].astype(np.uint64) << np.uint64(8 * e)
               for e in range(4))


def stage_table(mbig):
    """The table in shared memory: mma_table's bytes (B3 copies them; B17's
    convert_table writes the same from mbig), uint64."""
    return mma_table(mbig).numpy().astype(np.uint64)


def ldmatrix_x4(tab, row0, col0):
    """ldmatrix.x4 as the core issues it: lane L addresses table row
    row0 + (L >> 4)*8 + (L & 7) at byte col0 + 16 ((L >> 3) & 1); lane l
    receives, from matrix m, bytes 4 (l & 3) .. + 3 of the row that lane
    8m + (l >> 2) addressed. Returns [4 matrices, 32 lanes] words."""
    rows = row0 + (LANE >> 4) * 8 + (LANE & 7)
    cols = col0 + 16 * ((LANE >> 3) & 1)
    out = np.zeros((4, 32), dtype=np.uint64)
    for m in range(4):
        src = 8 * m + (LANE >> 2)
        out[m] = _pack(np.stack([tab[rows[src], cols[src] + 4 * TIG + e]
                                 for e in range(4)], axis=-1))
    return out


def mma_u8(d, a, b0, b1):
    """mma.sync.m16n8k32.row.col.s32.u8.u8.s32 over the 32 lanes'
    fragments: a [32, 4], b0, b1 [32] words, d [32, 4] s32 sums (int64
    here). A[g + 8 (i & 1), 4 tig + e + 16 (i >> 1)] = byte e of a_i;
    B[4 tig + e + 16 h, g] = byte e of b_h; D[g + 8 (e >> 1), 2 tig +
    (e & 1)] = c_e."""
    A = np.zeros((16, 32), dtype=np.int64)
    B = np.zeros((32, 8), dtype=np.int64)
    for ri in range(4):
        ab = _bytes(a[:, ri]).astype(np.int64)
        for e in range(4):
            A[G + 8 * (ri & 1), 4 * TIG + e + 16 * (ri >> 1)] = ab[:, e]
    for h, bh in enumerate((b0, b1)):
        bb = _bytes(bh).astype(np.int64)
        for e in range(4):
            B[4 * TIG + e + 16 * h, G] = bb[:, e]
    D = A @ B
    for e in range(4):
        d[:, e] += D[G + 8 * (e >> 1), 2 * TIG + (e & 1)]
        assert 0 <= d[:, e].max() < 1 << 23  # exact in s32, far from a wrap


def shoup_lazy(a, w, w_sh, q):
    """a * w - floor(a * w_sh / 2^32) * q as exact integers (uint64):
    the uint32 result of the kernel when it lies in [0, 2q)."""
    r = a * w - ((a * w_sh) >> np.uint64(32)) * q
    assert (r < 2 * q).all()
    return r


def epilogue(d, q, hsh):
    """csrc/bconv.cu's epilogue: the plane sums d[0..3] (uint64) of outputs
    over primes q with horner_sh hsh -> residues in [0, q)."""
    lo = d[0] + (d[1] << np.uint64(8))
    hi = d[2] + (d[3] << np.uint64(8))
    assert (lo < 1 << 31).all() and (hi < 1 << 31).all()  # no uint32 wrap
    r = (shoup_lazy(hi, np.uint64(1 << 16), hsh, q)
         + shoup_lazy(lo, np.uint64(1), hsh >> np.uint64(16), q))
    assert (r < 4 * q).all() and (4 * q < 1 << 32).all()
    r = np.where(r >= 2 * q, r - 2 * q, r)
    return np.where(r >= q, r - q, r)


def model(x, mbig, m_out, conv=None, rng=None, step2=None):
    """The schedule of B3 (conv = (s, s_sh, in_q, hsh, out_q, center)), B5
    (step2 = (hsh, out_q)) or B17 (neither) on x uint64 [nd_in, ncoef],
    one warp tile of 32 coefficients after another. Returns uint64
    [m_out, ncoef]: B3's or B5's residues, or B17's D_0."""
    nd_in, ncoef = x.shape
    center = conv[5] if conv else False
    nd = nd_in + int(center)
    ks, jb = _geometry(nd, m_out)
    tab = stage_table(mbig)
    assert tab.shape == (32 * jb, 32 * ks + 16)
    assert mma_smem_bytes(nd, m_out, not (conv or step2)) <= SMEM_LIMIT
    hsh, out_q = conv[3:5] if conv else step2 or (None, None)
    if conv:  # the constants of every staged row (Conv::stage)
        s, s_sh, in_q = conv[:3]
        rowc = np.zeros((8 * ks, 4), dtype=np.uint64)
        rowc[:, 2:] = MASK
        rowc[:nd_in] = np.stack([s, s_sh, in_q, (in_q >> np.uint64(1)) + 1],
                                axis=1)
    out = np.zeros((m_out, ncoef), dtype=np.uint64)
    for c0 in range(0, ncoef, 32):
        # the warp's staged tile: zero past ncoef, garbage past nd_in
        xs = rng.integers(0, 1 << 32, size=(8 * ks, 32), dtype=np.uint64)
        xs[:nd_in] = 0
        w = min(32, ncoef - c0)
        xs[:nd_in, :w] = x[:, c0:c0 + w]
        a = np.zeros((2, ks, 32, 4), dtype=np.uint64)
        cnt = np.zeros((2, 2, 32), dtype=np.uint64)
        for k in range(ks):
            for h2 in range(2):
                t = 8 * k + 4 * h2 + TIG
                for mt in range(2):
                    for h in range(2):
                        v = xs[t, 16 * mt + 8 * h + G]
                        if conv:  # Conv::input: step 1, the count
                            sv, ssh, qv, th = (rowc[t, i] for i in range(4))
                            v = shoup_lazy(v, sv, ssh, qv)
                            v = np.where(v >= qv, v - qv, v)
                            cnt[mt, h] += v >= th
                        else:  # Step2::input, PlanesMm::input
                            v = np.where(t < nd, v, 0)
                        a[mt, k, :, h + 2 * h2] = v
        if center:  # Conv::count: the quad's sum, into row t = nd_in
            for mt in range(2):
                for h in range(2):
                    v = cnt[mt, h] + cnt[mt, h][LANE ^ 1]
                    v = v + v[LANE ^ 2]
                    for k in range(ks):
                        for h2 in range(2):
                            hit = 8 * k + 4 * h2 + TIG == nd_in
                            a[mt, k, hit, h + 2 * h2] = v[hit]
        for b in range(jb):
            d = np.zeros((2, 4, 32, 4), dtype=np.int64)
            for k in range(ks):
                for ip in range(2):
                    bm = ldmatrix_x4(tab, (b * 4 + 2 * ip) * 8, 32 * k)
                    for mt in range(2):
                        mma_u8(d[mt, 2 * ip], a[mt, k], bm[0], bm[1])
                        mma_u8(d[mt, 2 * ip + 1], a[mt, k], bm[2], bm[3])
            for e in range(4):  # store: rows j, columns c of c_e
                j = 8 * b + 2 * TIG + (e & 1)
                for mt in range(2):
                    c = c0 + 16 * mt + 8 * (e >> 1) + G
                    ok = (j < m_out) & (c < ncoef)
                    dj = d[mt, :, :, e].astype(np.uint64)[:, ok]
                    if hsh is not None:  # Residues::store
                        out[j[ok], c[ok]] = epilogue(
                            dj, out_q[j[ok]], hsh[j[ok]])
                    else:
                        out[j[ok], c[ok]] = dj[0]
    return out


def _u64(t):
    return t.numpy().view(np.uint32).astype(np.uint64)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.uint64).astype(np.uint32)
                            .view(np.int32))


def _b3(x, tabs, center, rng):
    """model(...) and bconv_plain on x [nd, ncoef] for tables (s, s_sh,
    in_q, mat, mbig, hsh, out_q) as int32 tensors."""
    s, s_sh, in_q, mat, mbig, hsh, out_q = tabs
    got = model(x, mbig, out_q.shape[0],
                (_u64(s), _u64(s_sh), _u64(in_q), _u64(hsh), _u64(out_q),
                 center), rng)
    want = bconv_plain(_t(x)[:, None], s, s_sh, in_q, mat, out_q, center)
    return got, _u64(want[:, 0])


@pytest.mark.parametrize("nd,m_out", SHAPES)
def test_device_table_is_a_permutation(nd, m_out):
    """Every byte of build_bf16_tables' mbig lands in exactly one place of
    the staged table, and every other place is 0."""
    rng = np.random.default_rng(nd * 100 + m_out)
    q = np.array(nt.gen_ntt_primes(64, m_out), dtype=np.uint64)
    mat = rng.integers(0, q[:, None], size=(m_out, nd)).astype(np.uint64)
    mbig = build_bf16_tables(mat, q)[0]
    # the layout's position of every entry (row R, byte k), from its
    # definition, and the entries that land there
    ks, jb = _geometry(nd, m_out)
    i, j, p, t = np.meshgrid(np.arange(4), np.arange(m_out), np.arange(4),
                             np.arange(nd), indexing="ij")
    R, k = (j // 8 * 4 + i) * 8 + j % 8, 4 * t + p
    tagged = np.zeros((jb * 32, 32 * ks + 16), dtype=np.int64)
    np.add.at(tagged, (R.ravel(), k.ravel()),
              ((i * m_out + j) * 4 * nd + p * nd + t + 1).ravel())
    assert sorted(tagged[tagged > 0].tolist()) == list(
        range(1, mbig.numel() + 1))  # one place each, none shared
    tab = stage_table(mbig)
    assert tab.shape == tagged.shape
    flat = mbig.float().numpy().astype(np.uint64).ravel()
    np.testing.assert_array_equal(tab[tagged > 0],
                                  flat[tagged[tagged > 0].astype(int) - 1])
    assert not tab[tagged == 0].any()


@pytest.fixture(scope="module")
def tables():
    p = get_params(n=256, max_level=6, alpha=2)
    return p, DeviceContext(p, "cpu").keyswitch_tables(LEVEL)


def _cases(kt):
    """label -> (input primes, (s, s_sh, in_q, mat, mbig, hsh, out_q),
    center): ModUp digits, ModDown, the tail."""
    cases = {f"modup{d}": (dt.in_q, (dt.step1, dt.step1_sh, dt.in_q, dt.mat,
                                     dt.mat_bf16, dt.horner_sh,
                                     dt.other_nt.q), True)
             for d, dt in enumerate(kt.digits)}
    cases["moddown"] = (kt.special_nt.q, (
        kt.md_s1, kt.md_s1_sh, kt.special_nt.q, kt.md_mat, kt.md_bf16,
        kt.md_horner_sh, kt.main_nt.q), True)
    tt = kt.tail
    cases["tail"] = (tt.in_q, (tt.one, tt.one_sh, tt.in_q, tt.mat, tt.bf16,
                               tt.horner_sh, tt.out_nt.q), False)
    return cases


@pytest.mark.parametrize("which", ["modup0", "modup1", "modup2", "moddown",
                                   "tail"])
@pytest.mark.parametrize("ncoef", [256, 200])
def test_b3_model_matches_plain(tables, which, ncoef):
    """The context's conversions (ncoef 200: a ragged last warp tile),
    random inputs and, at 256, every input q - 1."""
    _, kt = tables
    in_q, tabs, center = _cases(kt)[which]
    rng = np.random.default_rng(ncoef)
    q = _u64(in_q)
    x = rng.integers(0, q[:, None], size=(len(q), ncoef), dtype=np.uint64)
    if ncoef == 256:
        x[:, :128] = q[:, None] - 1
    got, want = _b3(x, tabs, center, rng)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nd,m_out,center", [(15, 35, True), (18, 34, False),
                                             (31, 12, True), (32, 9, False)])
def test_b3_model_matches_plain_wide(nd, m_out, center):
    """Set B's digit and tail widths (KS 2, 3) and the widest tables (KS
    4, nd + center = 32) over the largest primes below PRIME_CAP."""
    rng = np.random.default_rng(nd)
    ndt = nd + int(center)
    in_q = np.array(nt.gen_ntt_primes(64, nd), dtype=np.uint64)
    out_q = np.array(nt.gen_ntt_primes(64, m_out + nd)[nd:], dtype=np.uint64)
    mat = rng.integers(0, out_q[:, None], size=(m_out, ndt)).astype(np.uint64)
    s = rng.integers(1, in_q).astype(np.uint64)
    s_sh = (s << np.uint64(32)) // in_q
    mbig, hsh = build_bf16_tables(mat, out_q)
    x = rng.integers(0, in_q[:, None], size=(nd, 96), dtype=np.uint64)
    x[:, :32] = in_q[:, None] - 1
    got, want = _b3(x, (_t(s), _t(s_sh), _t(in_q), _t(mat), mbig, hsh,
                        _t(out_q)), center, rng)
    np.testing.assert_array_equal(got, want)


# B5's widths: nd rows in all (the count row included) -> m_out rows; set
# B's ModUp digits 0/1 and ModDown (16 -> 35) and digit 2 (6 -> 45), one
# row, set A's alpha 28 plus the count row, and the widest table
B5_SHAPES = {1: 3, 6: 45, 16: 35, 29: 12, 32: 9}


def _b5_inputs(nd, m_out, worst, rng, ncoef=96):
    """xhat [nd, ncoef]: nd - 1 rows scaled by step 1 over the largest
    primes below PRIME_CAP and their centering count row last (nd = 1:
    one scaled row, no count); the matrix [m_out, nd] over the next m_out
    primes, so inputs exceed the output primes. worst: every scaled word
    q_i - 1, so the count row is nd - 1 everywhere."""
    k = max(nd - 1, 1)
    primes = np.array(nt.gen_ntt_primes(64, k + m_out), dtype=np.uint64)
    in_q, out_q = primes[:k], primes[k:]
    assert nt.PRIME_CAP - (1 << 20) < in_q.max() < nt.PRIME_CAP
    xs = rng.integers(0, in_q[:, None], size=(k, ncoef), dtype=np.uint64)
    if worst:
        xs[:] = in_q[:, None] - 1
    if nd > 1:
        thr = (in_q[:, None] >> np.uint64(1)) + np.uint64(1)
        xs = np.concatenate([xs, (xs >= thr).sum(axis=0, keepdims=True)])
    if worst:
        assert (xs[-1] == nd - 1).all() if nd > 1 else True
    mat = rng.integers(0, out_q[:, None], size=(m_out, nd)).astype(np.uint64)
    return xs.astype(np.uint64), mat, out_q


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("nd", list(B5_SHAPES))
def test_b5_model_matches_plain_and_pallas(nd, worst):
    """B5's Step2 schedule (B3's with step 1 and the count off) on nd
    rows, the count row last, against bconv_step2_plain and the TPU
    kernel B5 replaces (bconv_step2_pallas, interpret mode), tolerance 0;
    worst: every scaled input q_i - 1 (above every output prime), the
    count row nd - 1, output primes at the top of the band."""
    m_out = B5_SHAPES[nd]
    rng = np.random.default_rng(100 + nd)
    x, mat, out_q = _b5_inputs(nd, m_out, worst, rng)
    mbig, hsh = build_bf16_tables(mat, out_q)
    got = model(x, mbig, m_out, rng=rng, step2=(_u64(hsh), out_q))
    want = _u64(bconv_step2_plain(_t(x), _t(mat), _t(out_q)))
    np.testing.assert_array_equal(got, want)
    mat_sh = (mat << np.uint64(32)) // out_q[:, None]
    jax_out = np.asarray(bconv_step2_pallas(
        *(jnp.asarray(a.astype(np.uint32)) for a in (x, mat, mat_sh, out_q)),
        interpret=True))
    np.testing.assert_array_equal(got, jax_out.astype(np.uint64))


@pytest.mark.parametrize("which", ["modup0", "modup1", "modup2", "moddown"])
def test_b5_model_on_the_context_tables(tables, which):
    """The graph route's conversions as ops/keyswitch.py hands them to B5:
    torch step 1 and the count row, then the context's table and
    horner_sh of the same matrix (ncoef 200: a ragged last warp tile)."""
    from homulator_tpu_torch.ops.bconv import bconv_step1_centered

    _, kt = tables
    in_q, (s, s_sh, _, mat, mbig, hsh, out_q), _ = _cases(kt)[which]
    rng = np.random.default_rng(7)
    q = _u64(in_q)
    x = rng.integers(0, q[:, None], size=(len(q), 200), dtype=np.uint64)
    x[:, :32] = q[:, None] - 1
    xhat = bconv_step1_centered(_t(x), s, s_sh, in_q)
    assert xhat.shape[0] == mat.shape[1] == len(q) + 1
    got = model(xhat.numpy().astype(np.uint64), mbig, out_q.shape[0],
                rng=rng, step2=(_u64(hsh), _u64(out_q)))
    np.testing.assert_array_equal(
        got, _u64(bconv_step2_plain(xhat, mat, out_q)))


def test_b5_wrapper_needs_the_tables():
    """Off the CPU, bconv_step2 takes the kernel's tables or raises before
    it looks at the device or builds anything; on the CPU it runs the
    plain version without them."""
    xhat = torch.zeros((3, 64), dtype=torch.int32)
    mat = torch.ones((2, 3), dtype=torch.int32)
    out_q = torch.full((2,), 97, dtype=torch.int32)
    meta = xhat.to("meta")
    for tabs in ((None, None), (None, out_q.to("meta")),
                 (torch.zeros((32, 48), dtype=torch.uint8).to("meta"), None)):
        with pytest.raises(ValueError, match="device layout"):
            bconv_step2(meta, mat.to("meta"), *tabs, out_q.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        bconv_step2(meta, mat, torch.zeros((32, 48), dtype=torch.uint8),
                    out_q, out_q)
    assert torch.equal(bconv_step2(xhat, mat, None, None, out_q),
                       bconv_step2_plain(xhat, mat, out_q))


def test_worst_case_margins():
    """Every table byte 255 at nd = 32 over the largest primes below
    PRIME_CAP. B17 on every input byte 255: the plane sums reach
    4 * 32 * 255^2 = 8,323,200 < 2^23 and the folds 257 times that < 2^31;
    the epilogue reduces those sums to (D (1 + 2^8 + 2^16 + 2^24)) mod q,
    as B5 does on the same words. B3 with the tail's identity step 1 on
    x = q - 1 everywhere."""
    nd, m_out = 32, 9
    rng = np.random.default_rng(0)
    primes = np.array(nt.gen_ntt_primes(64, m_out + nd), dtype=np.uint64)
    out_q, in_q = primes[:m_out], primes[m_out:]
    assert nt.PRIME_CAP - (1 << 20) < out_q.max() < nt.PRIME_CAP
    hsh = (np.uint64(1 << 48) // out_q).astype(np.uint64)
    mbig = torch.full((4 * m_out, 4 * nd), 255.0).to(torch.bfloat16)
    d = 4 * nd * 255 * 255
    assert d < 1 << 23 and 257 * d < 1 << 31
    x = np.full((nd, 64), MASK, dtype=np.uint64)
    np.testing.assert_array_equal(model(x, mbig, m_out, rng=rng),
                                  np.full((m_out, 64), d, dtype=np.uint64))
    np.testing.assert_array_equal(
        epilogue(np.full((4, m_out), d, dtype=np.uint64), out_q, hsh),
        (d * 0x01010101) % out_q)
    # B5 on every word 2^32 - 1 (any uint32 enters the product as it is)
    np.testing.assert_array_equal(
        model(x, mbig, m_out, rng=rng, step2=(hsh, out_q)),
        np.repeat(((d * 0x01010101) % out_q)[:, None], 64, axis=1))
    x = np.repeat((in_q - 1)[:, None], 64, axis=1)
    ones = np.ones(nd, dtype=np.uint64)
    got = model(x, mbig, m_out,
                (ones, np.uint64(1 << 32) // in_q, in_q, hsh, out_q, False),
                rng)
    dsum = 255 * int(_bytes(in_q - 1).sum())
    np.testing.assert_array_equal(got, np.repeat(
        ((dsum * 0x01010101) % out_q)[:, None], 64, axis=1))


@pytest.mark.parametrize("nd,m_out,ncoef", [(16, 35, 128), (4, 5, 100),
                                            (32, 3, 64)])
def test_b17_model_matches_plain(nd, m_out, ncoef):
    """B17's schedule (x as it is, D_0 stored) against
    bconv_planes_mm_plain, any 32-bit input, the last row zero."""
    rng = np.random.default_rng(nd)
    q = np.array(nt.gen_ntt_primes(64, m_out), dtype=np.uint64)
    mat = rng.integers(0, q[:, None], size=(m_out, nd)).astype(np.uint64)
    mbig = build_bf16_tables(mat, q)[0]
    x = rng.integers(0, 1 << 32, size=(nd, ncoef), dtype=np.uint64)
    x[-1] = 0
    want = bconv_planes_mm_plain(_t(x)[:, None], mbig)[:, 0]
    np.testing.assert_array_equal(model(x, mbig, m_out, rng=rng),
                                  want.numpy().astype(np.uint64))


def test_context_tables_equal_jax():
    """The port's bf16 tables of every B3 conversion equal the JAX
    context's (ModUp digits, ModDown, the tail), tolerance 0."""
    jp = jax_params(n=256, max_level=6, alpha=2)
    jkt = JaxContext(jp, ntt_mode="interpret").keyswitch_tables(LEVEL)
    kt = DeviceContext(get_params(n=256, max_level=6, alpha=2),
                       "cpu").keyswitch_tables(LEVEL)
    pairs = [(dt.mat_bf16, dt.horner_sh, jd.mat_bf16, jd.horner_sh)
             for dt, jd in zip(kt.digits, jkt.digits)]
    pairs.append((kt.md_bf16, kt.md_horner_sh, jkt.moddown_bf16,
                  jkt.moddown_horner_sh))
    pairs.append((kt.tail.bf16, kt.tail.horner_sh, jkt.tail.bf16,
                  jkt.tail.horner_sh))
    assert len(pairs) == len(jkt.digits) + 2 == 5
    for mbig, hsh, jm, jh in pairs:
        np.testing.assert_array_equal(
            mbig.float().numpy(), np.asarray(jm.astype(np.float32)))
        np.testing.assert_array_equal(hsh.numpy().view(np.uint32),
                                      np.asarray(jh))
