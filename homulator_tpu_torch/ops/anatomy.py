"""NTT anatomy kernels B14, B15 and B16, and their plain versions.

The parts of the forward 4-step NTT's first phase, each a kernel of its
own (csrc/anatomy.cu, which has the design note), on limbs x int32
[M, n1, n2] of canonical residues over an unsharded NTT basis nb of M
rows. Every output is in [0, q):

  B14, `scripts/microbench_ntt.py::make_variant`: ntt_anatomy(x, nb, v)
    copy      x^T                                   -> [M, n2, n1]
    midT      (x * mid mod q)^T
    stages1   (the stage-1 CT butterflies along n1)^T
    stages2x  (stage 1 twice: 16 stages at n1 = 256)^T
    full      the forward NTT: kernel B1 itself (ops/ntt.py)
  B15, `scripts/microbench_ntt2.py::make_kernel`: ntt_shoup_forms(x, nb, f)
    stages2x, with the butterflies' Shoup product in form f: production
    (the exact high word, __umulhi), natmul (the exact high word from four
    16-bit partial products, the TPU's form) or approx (the TPU's
    3-product high word, short by at most 1)
  B16, `scripts/bench_ntt_variants.py::main` (k_copy, k_transpose, k_mid,
  k_stages1): ntt_components(x, nb, p)
    copy, transpose, mid (x * mid mod q), stages1; only transpose
    transposes                                       -> [M, n1, n2]

Every stage variant (B14's stages1 and stages2x, B15, B16's stages1) runs
B1's register passes (hk_ntt_stages: its phase A geometry, lazy ranges;
B14's stages2x is B15's production form); copy^T, midT, transpose and
mid are the column tiles' byte-bound variants (hk_ntt_anatomy); B16's copy
is a plain vectorised copy of its own (hk_copy_words).

The TPU kernels leave B14's stages1 and stages2x (and its full variant)
lazy in [0, 3q); they agree with these mod q. microbench_ntt2's natmul and
approx variants run the fine stages unswapped on row-swapped tables, so
they compute another function than stage 1 twice; these forms compute
stage 1 twice (PERF.md §6).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel,
counted once under its table's name in kernels.LAUNCHES, or raises.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..context import NttBasis
from .modmath import _u32, cond_sub, mulmod
from .ntt import _ct_stages, _rep_rows, _tables, ntt, ntt_plain
from .ntt_kernels import radix_phases

# the Shoup forms of B15, in hk_ntt_stages' numbering
FORMS = ("production", "natmul", "approx")
# variant -> (stage passes, mid product, transposed store): hk_ntt_stages
# runs the variants with stage passes (1 or 2 runs of B1's register
# passes), hk_ntt_anatomy the others; B14's "full" is B1, B16's "copy" its
# own kernel (hk_copy_words)
B14_VARIANTS = {"copy": (0, False, True), "midT": (0, True, True),
                "stages1": (1, False, True), "stages2x": (2, False, True),
                "full": None}
# form -> the function every form computes: B14's stages2x
B15_FORMS = {f: B14_VARIANTS["stages2x"] for f in FORMS}
B16_PARTS = {"copy": None, "transpose": (0, False, True),
             "mid": (0, True, False), "stages1": (1, False, False)}
# n1 the kernels take: the column tiles ([n1, 32], n1 * 33 words) and the
# production stage kernels (stages_radix at L = 1 .. 10)
_MAX_N1 = 1024
_MAX_N1_FORMS = 256  # natmul and approx: stages_radix at L = 1 .. 8


def shoup_form(a, w, w_sh, q, form: str) -> torch.Tensor:
    """a * w mod q in [0, q) (int64) through the high word of a * w_sh /
    2^32 of `form`, as the kernel computes it: production and natmul give
    the exact high word; approx drops the low partial product, so a * w -
    hi * q lies in [0, 3q). a, w < q < 2^32/6; w_sh uint32 bits."""
    a, wsh = a.long(), _u32(w_sh)
    if form == "approx":
        a0, a1, b0, b1 = a & 0xFFFF, a >> 16, wsh & 0xFFFF, wsh >> 16
        hi = a1 * b1 + ((a0 * b1 + a1 * b0) >> 16)
    elif form in ("production", "natmul"):
        hi = (a * wsh) >> 32
    else:
        raise ValueError(f"unknown Shoup form {form!r}")
    return cond_sub(cond_sub(a * w.long() - hi * q, q + q), q)


def _plain(spec: tuple, x: torch.Tensor, nb: NttBasis,
           form: str = "production") -> torch.Tensor:
    passes, mid, transposed = spec
    rows = _rep_rows(nb, 1)
    q, tw1, tw1_sh, mids = _tables(nb, rows, "q", "tw1", "tw1_sh", "mid")
    q4 = q.view(-1, 1, 1, 1)
    mul = None  # _ct_stages' own product is the production form
    if form != "production":
        def mul(v, lo, hi):
            return shoup_form(v, tw1[:, lo:hi, None, None],
                              tw1_sh[:, lo:hi, None, None], q4, form)
    y = x.long()
    for _ in range(passes):
        y = _ct_stages(y, tw1, q4, mul)
    if mid:
        y = mulmod(y, mids, q4[:, 0])
    if transposed:
        y = y.transpose(1, 2)
    return y.to(torch.int32).contiguous()


def _check(name: str, x: torch.Tensor, nb: NttBasis, tables,
           max_n1: int = _MAX_N1) -> None:
    """Raise unless x [M, n1, n2] and nb's q and `tables` are what the
    anatomy kernels take on x's CUDA device, n1 <= max_n1."""
    if not x.is_cuda:
        raise ValueError(f"{name}: CUDA kernel called on {x.device}")
    if nb.shard is not None:
        raise ValueError(f"{name}: sharded basis {nb.shard}")
    M, n1, n2 = nb.q.shape[0], nb.n1, nb.n2
    if n1 > max_n1:
        raise ValueError(f"{name}: n1={n1} above {max_n1}")
    kernels.require_cuda_int32("x", x, x.device, (M, n1, n2))
    kernels.require_cuda_int32("q", nb.q, x.device, (M,))
    for t in tables:
        kernels.require_cuda_int32(
            t, getattr(nb, t), x.device,
            (M, n1) if t.startswith("tw1") else (M, n1, n2))


def _launch(name: str, spec: tuple, x: torch.Tensor, nb: NttBasis,
            form: str = "production") -> torch.Tensor:
    """The variant `spec` on the GPU, counted under `name`: its stage
    passes on B1's register passes in Shoup form `form` (hk_ntt_stages,
    tiles of B1 phase A's width, radix_phases), or the column tiles'
    product and store (hk_ntt_anatomy)."""
    passes, mid, transposed = spec
    M, n1, n2 = nb.q.shape[0], nb.n1, nb.n2
    if passes:
        _check(name, x, nb, ("tw1", "tw1_sh"),
               _MAX_N1 if form == "production" else _MAX_N1_FORMS)
    else:
        _check(name, x, nb, ("mid", "mid_sh"))
    lib = kernels.load()
    out = torch.empty((M, n2, n1) if transposed else (M, n1, n2),
                      dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        if passes:
            tc = radix_phases(M, n1, n2, True)[0][2]
            rc = lib.hk_ntt_stages(
                kernels.ptr(x), kernels.ptr(out), kernels.ptr(nb.q),
                kernels.ptr(nb.tw1), kernels.ptr(nb.tw1_sh),
                FORMS.index(form), passes, int(transposed), M, M, n1, n2,
                tc.bit_length() - 1, kernels.stream(x))
        else:
            rc = lib.hk_ntt_anatomy(
                kernels.ptr(x), kernels.ptr(out), kernels.ptr(nb.q),
                kernels.ptr(nb.mid), kernels.ptr(nb.mid_sh), int(mid),
                int(transposed), M, M, n1, n2, kernels.stream(x))
    kernels.check(rc, name)
    kernels.count(name)
    return out


def _run(name: str, spec: tuple, x: torch.Tensor, nb: NttBasis,
         form: str = "production") -> torch.Tensor:
    if x.device.type == "cpu":
        return _plain(spec, x, nb, form)
    return _launch(name, spec, x, nb, form)


def _launch_copy(x: torch.Tensor, nb: NttBasis) -> torch.Tensor:
    """B16's copy on the GPU (hk_copy_words): x int32 [M, n1, n2] -> a new
    tensor of the same words, counted as ntt_components."""
    kernels.require_cuda_int32("x", x, x.device,
                               (nb.q.shape[0], nb.n1, nb.n2))
    lib = kernels.load()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.hk_copy_words(kernels.ptr(x), kernels.ptr(out), x.numel(),
                               kernels.stream(x))
    kernels.check(rc, "ntt_components")
    kernels.count("ntt_components")
    return out


def _spec(table: dict, key: str, what: str) -> tuple | None:
    if key not in table:
        raise ValueError(f"unknown {what} {key!r} (expected "
                         f"{'|'.join(table)})")
    return table[key]


def ntt_anatomy(x: torch.Tensor, nb: NttBasis, variant: str) -> torch.Tensor:
    """Kernel B14: `variant` of the forward NTT's first phase on x int32
    [M, n1, n2] -> [M, n2, n1] in [0, q) (see the module docstring);
    "full" is the NTT itself, kernel B1."""
    spec = _spec(B14_VARIANTS, variant, "B14 variant")
    if spec is None:
        return ntt(x, nb)
    return _run("ntt_anatomy", spec, x, nb)


def ntt_anatomy_plain(x: torch.Tensor, nb: NttBasis,
                      variant: str) -> torch.Tensor:
    """Plain version of kernel B14 (on the tensor's device; "full" is
    B1's plain version)."""
    spec = _spec(B14_VARIANTS, variant, "B14 variant")
    if spec is None:
        return ntt_plain(x, nb)
    return _plain(spec, x, nb)


def ntt_shoup_forms(x: torch.Tensor, nb: NttBasis, form: str) -> torch.Tensor:
    """Kernel B15: 16 CT stages (stage 1 twice) along n1 of x int32
    [M, n1, n2] with the Shoup product in `form` -> [M, n2, n1] in [0, q),
    the same for every form."""
    return _run("ntt_shoup_forms", _spec(B15_FORMS, form, "Shoup form"), x,
                nb, form)


def ntt_shoup_forms_plain(x: torch.Tensor, nb: NttBasis,
                          form: str) -> torch.Tensor:
    """Plain version of kernel B15 (the form's high word in int64, every
    product fully reduced)."""
    return _plain(_spec(B15_FORMS, form, "Shoup form"), x, nb, form)


def ntt_components(x: torch.Tensor, nb: NttBasis, part: str) -> torch.Tensor:
    """Kernel B16: one `part` of the 4-step NTT on x int32 [M, n1, n2]:
    copy, transpose ([M, n2, n1]), mid, stages1 ([M, n1, n2])."""
    spec = _spec(B16_PARTS, part, "B16 part")
    if x.device.type == "cpu":
        return ntt_components_plain(x, nb, part)
    if spec is None:
        return _launch_copy(x, nb)
    return _launch("ntt_components", spec, x, nb)


def ntt_components_plain(x: torch.Tensor, nb: NttBasis,
                         part: str) -> torch.Tensor:
    """Plain version of kernel B16 (on the tensor's device)."""
    spec = _spec(B16_PARTS, part, "B16 part")
    if spec is None:
        return x.clone()
    return _plain(spec, x, nb)
