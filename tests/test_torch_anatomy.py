"""The NTT anatomy kernels (B14, B15, B16), the bf16-plane product (B17)
and the roofline's peak chains: the port's plain versions against the JAX
kernels in interpret mode, at N = 2^12 (n1 = n2 = 64), M = 3 primes of the
top band (below numtheory.PRIME_CAP), inputs from numpy's generator.

Tolerances: 0 for B16, B17 and B14's copy and midT. B14's stages1,
stages2x and full leave the TPU kernel lazy in [0, 3q) (microbench_ntt.py
reduces them with two conditional subtracts), so those compare after the
JAX output is reduced mod q; B15's outputs are compared mod q as well.
The port's full variant is B1 and equals `ntt_pallas` bit for bit.

microbench_ntt2's natmul and approx variants run their fine stages (H < 8)
unswapped, but are fed `pfwd`, whose fine-stage columns are pre-permuted
for the row-bit swap at n >= 64 (homulator_tpu/context.py:294-312): given
tables built unswapped they compute natmul = base; given pfwd they do not.
Its approx variant also wraps: its product lies in [0, 3q) but the
butterfly adds only 2q before subtracting it, so u - v + 2q underflows
uint32; one conditional subtract of q after the product repairs it.
"""

import ast
import ctypes
import glob
import importlib
import importlib.util
import json
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from homulator_tpu.context import DeviceContext as JaxContext
from homulator_tpu.ops import bconv_fused as jbconv
from homulator_tpu.ops.modmath import mont_mul as jmont_mul
from homulator_tpu.ops.modmath import shoup_mul as jshoup_mul
from homulator_tpu.ops.modmath import shoup_mul_lazy3
from homulator_tpu.ops.ntt_pallas import (
    _SMEM_FULL, _csub, _ct_stages_val, _slab, ntt_pallas,
)
from homulator_tpu.params import get_params
from homulator_tpu_torch import benchlib, kernels
from homulator_tpu_torch.context import DeviceContext
from homulator_tpu_torch.ops import anatomy, peaks
from homulator_tpu_torch.ops.bconv_fused import (
    bconv_planes_mm, build_bf16_tables,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = (0, 1, 2)
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_entry_size_bytes",
               "jax_persistent_cache_min_compile_time_secs")


def _load_script(name):
    """scripts/<name>.py as a module. It sets a persistent compilation
    cache at import; those three settings are restored."""
    old = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    try:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "scripts", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in old.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def ctx():
    p = get_params(n=1 << 12, max_level=3, alpha=1)
    jnb = JaxContext(p, ntt_mode="interpret").ntt_basis(ROWS)
    tnb = DeviceContext(p, "cpu").ntt_basis(ROWS)
    q = p.q_arr[list(ROWS)].astype(np.int64)
    x = np.random.default_rng(0).integers(
        0, q[:, None, None], size=(len(ROWS), jnb.n1, jnb.n2)).astype(
            np.uint32)
    return types.SimpleNamespace(p=p, jnb=jnb, tnb=tnb, q=q, x=x,
                                 tx=torch.from_numpy(x.view(np.int32)))


def _pallas(kernel, specs, args, out_rc, M):
    return np.asarray(pl.pallas_call(
        kernel, grid=(M,), in_specs=specs, out_specs=_slab(*out_rc),
        out_shape=jax.ShapeDtypeStruct((M,) + out_rc, jnp.uint32),
        interpret=True)(*args))


def _q2d(ctx):
    return jnp.asarray(ctx.q.astype(np.uint32)).reshape(-1, 1)


# ---- B14: scripts/microbench_ntt.py::make_variant ---------------------------
@pytest.fixture(scope="module")
def mb1():
    return _load_script("microbench_ntt")


@pytest.mark.parametrize("variant", list(anatomy.B14_VARIANTS))
def test_b14_matches_microbench_ntt(ctx, mb1, variant):
    n1, n2, M = ctx.jnb.n1, ctx.jnb.n2, len(ROWS)
    l1, l2 = n1.bit_length() - 1, n2.bit_length() - 1
    specs = [_SMEM_FULL, _slab(n1, l1), _slab(n1, l1), _slab(n1, n2),
             _slab(n1, n2), _slab(n2, l2), _slab(n2, l2), _slab(n1, n2)]
    got = _pallas(mb1.make_variant(variant), specs,
                  (_q2d(ctx), *ctx.jnb.pfwd, jnp.asarray(ctx.x)), (n2, n1), M)
    port = anatomy.ntt_anatomy(ctx.tx, ctx.tnb, variant).numpy()
    assert port.min() >= 0 and (port < ctx.q[:, None, None]).all()
    if variant in ("copy", "midT"):  # tolerance 0
        np.testing.assert_array_equal(got.astype(np.int64), port)
    else:  # the TPU variant leaves [0, 3q): compared mod q
        np.testing.assert_array_equal(got % ctx.q[:, None, None], port)
    if variant == "full":  # the port's full is B1: equal to ntt_pallas
        want = ntt_pallas(jnp.asarray(ctx.x), jnp.asarray(ctx.jnb.q),
                          ctx.jnb.pfwd, n1=n1, n2=n2, interpret=True)
        np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                      port)


# ---- B15: scripts/microbench_ntt2.py::make_kernel ---------------------------
@pytest.fixture(scope="module")
def mb2():
    mod = _load_script("microbench_ntt2")
    # the roll form's pltpu.roll does not run in interpret mode on the CPU
    mod.pltpu = types.SimpleNamespace(
        roll=lambda a, shift, axis: jnp.roll(a, shift, axis=axis))
    return mod


def _unswapped(ctx):
    """Stage-1 Shoup tables [M, n1, log2 n1] built as _expand builds them
    below n = 64: column s, row r holds stage_tw[s][:, r >> (logn - s)]."""
    n = ctx.jnb.n1
    logn = n.bit_length() - 1
    r = np.arange(n)
    w = np.zeros((len(ROWS), n, logn), dtype=np.uint64)
    for s, arr in enumerate(ctx.p.ntt.sub1.stage_tw):
        w[:, :, s] = np.asarray(arr, dtype=np.uint64)[list(ROWS)][
            :, r >> (logn - s)]
    w_sh = (w << np.uint64(32)) // ctx.q.astype(np.uint64)[:, None, None]
    return jnp.asarray(w.astype(np.uint32)), jnp.asarray(
        w_sh.astype(np.uint32))


def _b15(ctx, mb2, which, tables):
    n1, n2, M = ctx.jnb.n1, ctx.jnb.n2, len(ROWS)
    l1 = n1.bit_length() - 1
    specs = [_SMEM_FULL, _slab(n1, l1), _slab(n1, l1), _slab(n1, n2)]
    return _pallas(mb2.make_kernel(which), specs,
                   (_q2d(ctx), *tables, jnp.asarray(ctx.x)), (n2, n1), M)


@pytest.fixture(scope="module")
def b15_base(ctx, mb2):
    """microbench_ntt2's base variant: the production stage loop on pfwd."""
    return _b15(ctx, mb2, "base", ctx.jnb.pfwd[:2])


@pytest.mark.parametrize("form", list(anatomy.B15_FORMS))
def test_b15_forms_match_base(ctx, b15_base, form):
    """Each port form equals microbench_ntt2's base variant mod q, and
    stage 1 twice (B14's stages2x)."""
    base = b15_base
    port = anatomy.ntt_shoup_forms(ctx.tx, ctx.tnb, form).numpy()
    np.testing.assert_array_equal(base % ctx.q[:, None, None], port)
    np.testing.assert_array_equal(
        port, anatomy.ntt_anatomy(ctx.tx, ctx.tnb, "stages2x").numpy())


@pytest.mark.parametrize("which,tables,equal", [
    ("natmul", "unswapped", True),
    ("natmul", "pfwd", False),  # the table fault
    ("approx", "pfwd", False),
    ("approx", "unswapped", False),  # u - v + 2q wraps for v in [2q, 3q)
    ("approx+csub", "unswapped", True),
])
def test_b15_jax_variants_pin_table_fault(ctx, mb2, monkeypatch, which,
                                          tables, equal):
    """microbench_ntt2's natmul equals stage 1 twice only on unswapped
    tables; its approx variant needs a conditional subtract of q after
    the product as well (patched in as `approx+csub`)."""
    if which == "approx+csub":
        approx = mb2.shoup_approx
        monkeypatch.setattr(mb2, "shoup_approx",
                            lambda a, w, wsh, q: _csub(approx(a, w, wsh, q),
                                                       q))
        which = "approx"
    tabs = _unswapped(ctx) if tables == "unswapped" else ctx.jnb.pfwd[:2]
    got = _b15(ctx, mb2, which, tabs) % ctx.q[:, None, None]
    port = anatomy.ntt_shoup_forms(ctx.tx, ctx.tnb, "production").numpy()
    assert np.array_equal(got, port) == equal


def test_shoup_forms_products(ctx):
    """The forms' products on random residues: each a * w mod q."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(ctx.q[:, None])
    a = torch.from_numpy(rng.integers(0, ctx.q[:, None], size=(3, 4096)))
    w = torch.from_numpy(rng.integers(0, ctx.q[:, None], size=(3, 4096)))
    w_sh = ((w << 32) // q).to(torch.int32)  # uint32 bits
    for form in anatomy.B15_FORMS:
        got = anatomy.shoup_form(a, w, w_sh, q, form)
        assert torch.equal(got, a * w % q), form
    with pytest.raises(ValueError):
        anatomy.shoup_form(a, w, w_sh, q, "mulhi")


# ---- B16: scripts/bench_ntt_variants.py::main's kernels ---------------------
# restated from bench_ntt_variants.py:67-83 (nested in its main())
def k_copy(x_ref, o_ref):
    o_ref[0] = x_ref[0]


def k_transpose(x_ref, o_ref):
    o_ref[0] = x_ref[0].T


def k_mid(q_ref, mid_ref, mids_ref, x_ref, o_ref):
    i = pl.program_id(0)
    q = q_ref[i, 0]
    a = shoup_mul_lazy3(x_ref[0], mid_ref[0], mids_ref[0], q)
    o_ref[0] = _csub(_csub(a, q + q), q)


def k_stages1(q_ref, p1_ref, p1s_ref, x_ref, o_ref):
    i = pl.program_id(0)
    q = q_ref[i, 0]
    a = _ct_stages_val(x_ref[0], p1_ref[0], p1s_ref[0], q, False)
    o_ref[0] = _csub(_csub(_csub(a, 4 * q), q + q), q)


@pytest.mark.parametrize("part", list(anatomy.B16_PARTS))
def test_b16_matches_bench_ntt_variants(ctx, part):
    n1, n2, M = ctx.jnb.n1, ctx.jnb.n2, len(ROWS)
    l1 = n1.bit_length() - 1
    p1, p1s, mid, mids, _, _ = ctx.jnb.pfwd
    x = jnp.asarray(ctx.x)
    kernel, specs, args, out_rc = {
        "copy": (k_copy, [_slab(n1, n2)], (x,), (n1, n2)),
        "transpose": (k_transpose, [_slab(n1, n2)], (x,), (n2, n1)),
        "mid": (k_mid, [_SMEM_FULL, _slab(n1, n2), _slab(n1, n2),
                        _slab(n1, n2)], (_q2d(ctx), mid, mids, x), (n1, n2)),
        "stages1": (k_stages1, [_SMEM_FULL, _slab(n1, l1), _slab(n1, l1),
                                _slab(n1, n2)], (_q2d(ctx), p1, p1s, x),
                    (n1, n2)),
    }[part]
    got = _pallas(kernel, specs, args, out_rc, M)
    port = anatomy.ntt_components(ctx.tx, ctx.tnb, part).numpy()
    np.testing.assert_array_equal(got.astype(np.int64), port)  # tolerance 0


def test_anatomy_rejects_unknown_names(ctx):
    for fn in (anatomy.ntt_anatomy, anatomy.ntt_shoup_forms,
               anatomy.ntt_components):
        with pytest.raises(ValueError):
            fn(ctx.tx, ctx.tnb, "nope")


# ---- B17: scripts/roofline.py::main._mm_kernel ------------------------------
def _mm_kernel(x_ref, mat_ref, o_ref):  # restated from roofline.py:359-367
    x = x_ref[:]
    planes = [((x >> (8 * k)) & 255).astype(jnp.int32).astype(jnp.bfloat16)
              for k in range(4)]
    xbig = jnp.concatenate(planes, axis=0)
    d_ = jax.lax.dot_general(
        mat_ref[:], xbig, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)
    o_ref[:] = d_.astype(jnp.int32).astype(jnp.uint32)[: o_ref.shape[0]]


@pytest.mark.parametrize("nd,m_out,R,C", [(4, 5, 16, 64), (16, 35, 8, 128)])
def test_b17_matches_roofline_mm_kernel(ctx, nd, m_out, R, C):
    """nd input rows (the zero row appended last, as roofline.py pads
    the digit) -> rows [:m_out] of mbig @ planes: tolerance 0, with the
    tables of both build_bf16_tables equal as float32."""
    rng = np.random.default_rng(nd)
    q_rows = ctx.p.q_arr[rng.integers(0, ctx.p.num_primes, size=m_out)]
    mat = rng.integers(0, q_rows[:, None], size=(m_out, nd)).astype(
        np.uint64)
    jm, jh = jbconv.build_bf16_tables(mat, q_rows.astype(np.uint64))
    tm, th = build_bf16_tables(mat, q_rows)
    np.testing.assert_array_equal(np.asarray(jm.astype(jnp.float32)),
                                  tm.float().numpy())
    np.testing.assert_array_equal(np.asarray(jh), th.numpy().view(np.uint32))
    x = rng.integers(0, 1 << 30, size=(nd, R, C)).astype(np.uint32)
    x[-1] = 0
    bn = 8
    got = np.asarray(pl.pallas_call(
        _mm_kernel, grid=(R // bn,),
        in_specs=[pl.BlockSpec((nd, bn, C), lambda j: (0, j, 0)),
                  pl.BlockSpec(jm.shape, lambda j: (0, 0))],
        out_specs=pl.BlockSpec((m_out, bn, C), lambda j: (0, j, 0)),
        out_shape=jax.ShapeDtypeStruct((m_out, R, C), jnp.uint32),
        interpret=True)(jnp.asarray(x), jm))
    port = bconv_planes_mm(torch.from_numpy(x.view(np.int32)), tm)
    np.testing.assert_array_equal(got.astype(np.int64), port.numpy())


def test_b17_raises_above_nd_32(ctx):
    q = ctx.p.q_arr[:2]
    with pytest.raises(ValueError):
        build_bf16_tables(np.ones((2, 33), dtype=np.uint64), q)
    tm = build_bf16_tables(np.ones((2, 32), dtype=np.uint64), q)[0]
    with pytest.raises(ValueError):
        bconv_planes_mm(torch.zeros((33, 8, 32), dtype=torch.int32),
                        torch.cat([tm, tm[:, :4]], dim=1))


# ---- the roofline's peak chains (scripts/roofline.py:182-267) --------------
@pytest.fixture(scope="module")
def chain_input():
    return np.random.default_rng(6).integers(0, peaks.Q, size=4096).astype(
        np.uint32)


def _jax_chain(link, x, iters):
    out = jax.jit(lambda y: jax.lax.fori_loop(
        0, iters * peaks.S, lambda _, v: link(v), y))(jnp.asarray(x))
    return np.asarray(out)


@pytest.mark.parametrize("op", ["square", "shoup", "mont"])
def test_peak_chains_match_jax(chain_input, op):
    """Two iterations (64 links) of each chain's plain version against the
    same loop of roofline.py's link in JAX (shoup_mul, mont_mul)."""
    q = jnp.uint32(peaks.Q)
    link = {
        "square": lambda y: y * y + jnp.uint32(12345),
        "shoup": lambda y: jshoup_mul(y, jnp.uint32(peaks.W),
                                      jnp.uint32(peaks.W_SH), q),
        "mont": lambda y: jmont_mul(y, jnp.uint32(peaks.W_MONT), q,
                                    jnp.uint32(peaks.QINV_NEG)),
    }[op]
    want = _jax_chain(link, chain_input, 2)
    got = peaks.chain(torch.from_numpy(chain_input.view(np.int32)), 2, op)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_peak_stream_matches_numpy():
    rng = np.random.default_rng(7)
    z, x = (rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(
        np.uint32) for _ in range(2))
    got = peaks.stream(torch.from_numpy(z.view(np.int32)),
                       torch.from_numpy(x.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  z * np.uint32(peaks.STREAM_MUL) ^ x)


# ---- the GPU tools' own consistency -----------------------------------------
_TOOLS = ["chip_smoke.py"] + sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "scripts", "*_torch.py")))


def _load_root_module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", _TOOLS)
def test_tool_imports_resolve(path):
    """Every `from X import Y` of chip_smoke.py and the port's scripts,
    those inside functions included (the tools import after their CUDA
    check, so no run on the CPU reaches them), names a module of the port
    or chip_smoke, and a name that module has."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    checked = 0
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ImportFrom) and node.level == 0
                and node.module.split(".")[0] in ("homulator_tpu_torch",
                                                  "chip_smoke")):
            continue
        mod = (_load_root_module(node.module) if node.module == "chip_smoke"
               else importlib.import_module(node.module))
        for alias in node.names:
            if not hasattr(mod, alias.name):  # a submodule not yet loaded
                importlib.import_module(f"{node.module}.{alias.name}")
            checked += 1
    assert checked, f"{path} imports nothing of the port"


def test_op_counts_fit_measured_peaks():
    """benchlib.OPS is the one count of a modular product: at that count
    the chains measured on the card (ROOFLINE_H100.json) imply an int32
    rate no higher than the one the bounds divide by, chip_smoke counts a
    chain link with it, and the roofline's NTT issue ceiling used it."""
    with open(os.path.join(ROOT, "ROOFLINE_H100.json")) as f:
        roof = json.load(f)
    ops = benchlib.OPS
    for prod, key in (("shoup", "peak_shoup_modmul_per_s"),
                      ("mont", "peak_mont_modmul_per_s")):
        assert ops[prod] * roof[key] <= benchlib.INT32_OPS_PER_S, prod
    assert ops["butterfly"] == ops["shoup"] + 2 * ops["modadd"]
    n = 1 << 16
    assert roof["ntt_ops_per_elem"] == (benchlib.radix_ntt_ops(1, n, True)
                                        + benchlib.radix_ntt_ops(1, n, False)
                                        ) / (2 * n)
    assert _load_root_module("chip_smoke").PEAK_LINK_OPS == {
        "square": 1, "shoup": ops["shoup"], "mont": ops["mont"]}


def test_anatomy_variants_instantiated():
    """The column-tile variants ops/anatomy.py asks hk_ntt_anatomy for
    (B14, B16 without stage passes) are the ones csrc/anatomy.cu
    instantiates, each row's flags equal to its template's; the stage
    variants it asks hk_ntt_stages for (B14's and B16's stages, B15's
    forms: form, runs, store) are stage_kernel's instantiations of
    stages_radix, each product form one that csrc/modarith.cuh defines,
    at the axis lengths the wrapper admits (production up to _MAX_N1,
    natmul and approx up to _MAX_N1_FORMS)."""
    csrc = os.path.join(ROOT, "homulator_tpu_torch", "csrc")
    with open(os.path.join(csrc, "anatomy.cu")) as f:
        src = f.read()
    rows = re.findall(r"\{(true|false), (true|false), "
                      r"anatomy<(true|false), (true|false)>\}", src)
    built = set()
    for mid, t, tmid, tt in rows:
        assert (mid, t) == (tmid, tt)
        built.add((0, mid == "true", t == "true"))
    tables = (anatomy.B14_VARIANTS, anatomy.B16_PARTS)
    specs = {spec for table in tables for spec in filter(None,
                                                         table.values())}
    assert len(built) == len(rows)
    assert {s for s in specs if s[0] == 0} == built  # each asked, each used
    assert "ct_rows(" not in src  # no column tile runs a stage
    stages = re.findall(r"&stages_radix<L, hk::(\w+), (\d), (true|false)>",
                        src)
    forms = dict(zip(anatomy.FORMS, ("ShoupLazy", "ShoupNatmul",
                                     "ShoupApprox")))
    asked = {("production", s[0], s[2]) for s in specs if s[0]} | {
        (f, *anatomy.B15_FORMS[f][::2]) for f in anatomy.FORMS}
    assert len(stages) == len(set(stages))
    assert {(f, int(r), t == "true") for f, r, t in stages} == {
        (forms[f], r, t) for f, r, t in asked}
    with open(os.path.join(csrc, "modarith.cuh")) as f:
        defined = set(re.findall(r"^struct (\w+) \{", f.read(), re.M))
    assert set(forms.values()) <= defined
    with open(os.path.join(csrc, "ntt_tile.cuh")) as f:
        assert "ct_rows" not in f.read()
    # the axis lengths hk_ntt_stages instantiates, the wrapper's limits:
    # with_log's default (ntt_reg.cuh) for production, kMaxLForms for the
    # TPU's forms
    assert re.findall(r"with_log\(ilog2\(n1\)", src)
    with open(os.path.join(csrc, "ntt_reg.cuh")) as f:
        assert re.search(r"template <int kMaxL = (\d+),", f.read()).group(
            1) == str(anatomy._MAX_N1.bit_length() - 1)
    assert re.findall(r"constexpr int kMaxLForms = (\d+);", src) == [
        str(anatomy._MAX_N1_FORMS.bit_length() - 1)]


def _c_params():
    """name -> the parameter list of each extern "C" entry of csrc/*.cu."""
    out = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "homulator_tpu_torch",
                                              "csrc", "*.cu"))):
        with open(path) as f:
            for m in re.finditer(r"^int (hk_\w+)\(([^)]*)\)", f.read(),
                                 re.M):
                out[m.group(1)] = [p.strip() for p in m.group(2).split(",")]
    return out


@pytest.mark.parametrize("name", list(kernels._SIGNATURES))
def test_kernel_signatures_match_sources(name):
    """kernels._SIGNATURES, the ctypes argument types each C entry is
    called with, equals the entry's parameters in its source, one for
    one: a pointer c_void_p, a long long c_longlong, an unsigned c_uint,
    an int c_int (no nvcc here, so a mismatch would show only on the
    card)."""
    def kind(p):
        if "*" in p:
            return ctypes.c_void_p
        if p.startswith("long long"):
            return ctypes.c_longlong
        if p.startswith("unsigned "):
            return ctypes.c_uint
        assert p.startswith("int "), p
        return ctypes.c_int
    params = _c_params()[name]
    assert [kind(p) for p in params] == kernels._SIGNATURES[name]


def test_chip_smoke_reads_stage_kernel_ptxas():
    """chip_smoke's ptxas parser reads each stages_radix instantiation
    that anatomy.cu takes the address of (mangled as nvcc's host compiler
    mangles a template of the anonymous namespace) with its axis, form,
    runs and store, as many as CHECKED_INSTANTIATIONS holds it to, and
    its local-memory bytes."""
    smoke = _load_root_module("chip_smoke")
    with open(os.path.join(ROOT, "homulator_tpu_torch", "csrc",
                           "anatomy.cu")) as f:
        stages = re.findall(r"&stages_radix<L, hk::(\w+), (\d), (true|false)>",
                            f.read())
    lines, want = [], {}
    for form, runs, t in stages:
        n1 = anatomy._MAX_N1 if form == "ShoupLazy" else anatomy._MAX_N1_FORMS
        for L in range(1, n1.bit_length()):
            lines += [
                "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N_"
                f"_0a1b_10anatomy_cu_5c2d12stages_radixILi{L}EN2hk"
                f"{len(form)}{form}ELi{runs}ELb{int(t == 'true')}EEEvPKjPjS4"
                "_S4_S4_iii' for 'sm_90a'",
                "ptxas info    : Function properties for x",
                f"    {L % 2 * 8} bytes stack frame, 0 bytes spill stores, 0 "
                "bytes spill loads",
                f"ptxas info    : Used {20 + L} registers, 380 bytes cmem[0]"]
            want[(L, form, int(runs), "T" if t == "true" else "R")] = (
                20 + L, L % 2 * 8)
    got = smoke.kernel_registers("\n".join(lines))
    assert got == {"stages_radix": want}
    assert len(want) == smoke.CHECKED_INSTANTIATIONS["stages_radix"]
