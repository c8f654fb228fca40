"""Timing helpers of the port: the counterpart of `homulator_tpu/benchlib.py`.

The JAX package times a device-side chained loop and takes a difference
quotient (`time_chained`), because a single dispatch through its TPU
transport cannot be timed reliably. That is a workaround for the
transport, not part of what is measured, so it has no counterpart here:
on the card, CUDA events bracket the work.

  latency_ms(fn)  median over eager calls of fn, each between two CUDA
                  events and synchronised: what a caller waits for, host
                  overhead included.
  device_ms(fn)   device time of one call without host overhead: calls
                  captured in a CUDA graph, the graph replayed between
                  CUDA events.
  profiled_ms(fn) device kernel time of one call under torch.profiler,
                  where no graph can be captured (the shard threads of a
                  ThreadMesh), by kernel group.

The op timers (ntt_pair_ms, hmult_ms, hrotate_ms, hadd_ms, padd_ms,
pmult_ms: the JAX package's *_seconds) return the device time of one call,
or its eager latency with eager=True. peak_rates measures the roofline's
five peaks (scripts/roofline_torch.py) on peak_inputs. Every timer needs a
CUDA device and none falls back to the CPU.

The bound of a kernel call (chip_smoke.py, scripts/roofline_torch.py):
bound() is the largest of the bytes it must move over MEM_BYTES_PER_S,
its int32 operations over INT32_OPS_PER_S (the float32 peak of 67 TFLOP/s,
128 lanes an SM and an FMA two operations, over four, as an H100 SM has
64 int32 lanes) and its tensor-core u8 operations over INT8_OPS_PER_S.
OPS is the one count of int32 operations a primitive costs;
radix_ntt_ops counts a transform of B1 or B2 with it, hpip_ops a call of
B4, radix_phase1_ops one of B6, B10 or B13, radix_phase2_ops one of B7,
B11 or B12 (and of B14's and B16's stages1, one run of the anatomy's
stage kernel), shoup_forms_ops one of B15 or B14's stages2x (two runs).
"""

from __future__ import annotations

import collections
import statistics
import subprocess

import numpy as np
import torch

from .ops import peaks
from .ops.ntt import intt, ntt

MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
INT8_OPS_PER_S = 1979e12  # dense tensor-core rate, int8 (and u8)
# int32 operations of a primitive. A Shoup product: a high and two low
# multiplies, a subtract, and an unsigned min as the conditional subtract,
# 5; the Shoup chain (csrc/peaks.cu) runs 3.06 T links/s on an H100, room
# for 5.47 operations a link at INT32_OPS_PER_S (PERF.md). A Montgomery
# product 5 the same way; a modular add or subtract 3; a butterfly a Shoup
# product, an add and a subtract; a lazy Shoup product-accumulate 6; a
# final reduction 6. Lazy forms (csrc/ntt_reg.cuh): a Shoup product
# without its conditional subtract 4; a conditional subtract 2; a Harvey
# butterfly (ct_lazy, gs_lazy) a lazy product, a conditional subtract and
# three adds or subtracts, 9; B4's accumulate (csrc/hpip.cu) a Montgomery
# product without its conditional subtract (4), an add and a conditional
# subtract, 7. B3's epilogue (csrc/bconv.cu) from four plane sums to a
# residue: two shift-and-add folds (4), a lazy Shoup product by 2^16 (4),
# a lazy reduction of the low fold (3), their sum (1) and two conditional
# subtracts (4), 16.
OPS = dict(shoup=5, mont=5, modadd=3, lazy_mac=6, reduce=6, lazy_shoup=4,
           csub=2, planes_reduce=16)
OPS["butterfly"] = OPS["shoup"] + 2 * OPS["modadd"]
OPS["lazy_butterfly"] = OPS["lazy_shoup"] + OPS["csub"] + 3
OPS["lazy_mont_mac"] = (OPS["mont"] - 1) + 1 + OPS["csub"]


def bound(nbytes, ops, tc_ops=0):
    """(bound_ms, bound_by) of a call moving nbytes and doing ops int32
    operations and tc_ops tensor-core u8 operations, each at the card's
    peak rate: bound_by "bytes" or "operations", whichever takes longer."""
    t_mem = nbytes / MEM_BYTES_PER_S
    t_ops = max(ops / INT32_OPS_PER_S, tc_ops / INT8_OPS_PER_S)
    return 1e3 * max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations"


def radix_ntt_ops(rows, n, fwd):
    """int32 operations of B1 (fwd) or B2 on `rows` limbs of n coefficients
    as csrc/ntt_reg.cuh computes them: n/2 * log2(n) Harvey butterflies
    and, an element, B1's mid product reduced to [0, q) (a lazy product and
    a conditional subtract) and two conditional subtracts before phase B's
    store; B2's lazy mid_inv product and one conditional subtract before
    each phase's store."""
    per_elem = OPS["lazy_shoup"] + (3 if fwd else 2) * OPS["csub"]
    return rows * (n // 2 * (n.bit_length() - 1) * OPS["lazy_butterfly"]
                   + n * per_elem)


def radix_phase1_ops(rows, n, c):
    """int32 operations of B6 or B10 (csrc/ntt_reg.cuh::radix_phase1) on
    `rows` limb slices [n, c]: n/2 * log2(n) Harvey butterflies on each of
    c columns and, an element, the mid product reduced to [0, q) (a lazy
    product and a conditional subtract). B9 and B13 (radix_iphase1) do as
    many: their GS butterfly costs what a CT one does (9), and an element
    takes the lazy mid_inv product before them and a conditional subtract
    after them."""
    return rows * c * (n // 2 * (n.bit_length() - 1) * OPS["lazy_butterfly"]
                       + n * (OPS["lazy_shoup"] + OPS["csub"]))


def radix_phase2_ops(rows, n, c, fwd=True):
    """int32 operations of B7 or B11 (fwd: csrc/ntt_reg.cuh::radix_phase,
    B1's phase B) or B8 or B12 (B2's phase A) on `rows` limb slices [n,
    c]: n/2 * log2(n) Harvey butterflies on each of c columns and, an
    element, the conditional subtracts before the store: two from [0, 4q)
    forward, one from [0, 2q) inverse. One run of the anatomy's stage
    kernel (csrc/anatomy.cu::stages_radix: B14's and B16's stages1) does
    the forward count on `rows` limbs [n, c]."""
    return rows * c * (n // 2 * (n.bit_length() - 1) * OPS["lazy_butterfly"]
                       + n * (2 if fwd else 1) * OPS["csub"])


def shoup_forms_ops(rows, n1, n2):
    """int32 operations of B15 and B14's stages2x (two runs of
    csrc/anatomy.cu::stages_radix) on `rows` limbs [n1, n2]: two runs of
    the register passes along n1 (n1/2 * log2(n1) Harvey butterflies a
    column each) and, an element, two conditional subtracts before the
    store; one count for every Shoup form, which do the same work."""
    return rows * n2 * (2 * (n1 // 2) * (n1.bit_length() - 1)
                        * OPS["lazy_butterfly"] + 2 * n1 * OPS["csub"])


def hpip_ops(conv_rows, K, beta, n):
    """int32 operations of B4 (csrc/hpip.cu) at a level with K ext rows and
    beta digits, conv_rows converted rows in all, n coefficients a row:
    each converted row's forward NTT as B1's phases compute it (n/2 *
    log2(n) Harvey butterflies, and an element phase A's mid product
    reduced to [0, q)), with no reduction after phase B; beta x 2 x K rows
    of lazy Montgomery product-accumulates; one conditional subtract an
    output word."""
    return (conv_rows * (n // 2 * (n.bit_length() - 1)
                         * OPS["lazy_butterfly"]
                         + n * (OPS["lazy_shoup"] + OPS["csub"]))
            + beta * 2 * K * n * OPS["lazy_mont_mac"]
            + 2 * K * n * OPS["csub"])


def latency_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median over `iters` eager calls of fn, each between two CUDA events
    and synchronised: what a caller waits for, host overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls: int = 10, replays: int = 20) -> float:
    """Device time of one fn call without host overhead: `calls` calls
    captured in a CUDA graph, the graph replayed `replays` times between
    CUDA events; the median replay divided by `calls`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as advised
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def profiled_ms(fn, calls: int = 5, group_of=None):
    """(device kernel ms per call, {group: ms per call}, {waiting runtime
    call: count per call}) of fn over `calls` eager calls under
    torch.profiler (CUPTI sees the kernels and runtime calls of every
    thread, so this times the shard threads of a ThreadMesh too, where a
    CUDA graph cannot be captured). group_of(kernel name) names a kernel's
    group (one group "all" without it); the waiting runtime calls are the
    synchronise, memcpy and event-query calls."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = collections.defaultdict(float)
    waits = collections.defaultdict(int)
    for e in prof.events():
        # a record_function range (a span, stats.span) is mirrored on the
        # device's timeline as a user annotation: not device work
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us[group_of(e.name) if group_of else "all"] += \
                e.time_range.elapsed_us()
        elif e.name.startswith("cuda") and any(
                k in e.name for k in ("Synchronize", "Memcpy", "EventQuery")):
            waits[e.name] += 1
    total = sum(us.values())
    if total == 0:
        raise RuntimeError("the profiler recorded no device kernels")
    return (total / calls / 1e3, {g: v / calls / 1e3 for g, v in us.items()},
            {k: v / calls for k, v in waits.items()})


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (first card)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def residues(q, shape, rng=0) -> torch.Tensor:
    """int32 tensor of `shape` on the card: uniform residues, row i of the
    first axis mod q[i] (q numpy or torch; rng numpy's generator or its
    seed)."""
    if isinstance(q, torch.Tensor):
        q = q.cpu().numpy()
    q = np.asarray(q, dtype=np.int64).reshape((-1,) + (1,) * (len(shape) - 1))
    x = np.random.default_rng(rng).integers(0, q, size=shape, dtype=np.int64)
    return torch.from_numpy(x.astype(np.int32)).cuda()


def _time(fn, eager: bool) -> float:
    return latency_ms(fn) if eager else device_ms(fn, calls=2)


def ntt_pair_ms(eng, x: torch.Tensor, level: int) -> float:
    """Device time of one NTT after one iNTT (B2 then B1) of `level`
    limbs: x int32 eval tiles [level, n2, n1] on the card."""
    nb = eng.dc.ntt_basis(eng.dc.main_rows(level))
    return device_ms(lambda: ntt(intt(x, nb), nb))


def hmult_ms(eng, ct1, ct2, eager: bool = False) -> float:
    return _time(lambda: eng.hmult(ct1, ct2), eager)


def hrotate_ms(eng, ct, step: int = 1, eager: bool = False) -> float:
    if step not in eng.rot_keys:
        eng.gen_rotation_key(step)
    return _time(lambda: eng.hrotate(ct, step), eager)


def hadd_ms(eng, ct1, ct2, eager: bool = False) -> float:
    return _time(lambda: eng.hadd(ct1, ct2), eager)


def padd_ms(eng, ct, pt, eager: bool = False) -> float:
    return _time(lambda: eng.padd(ct, pt), eager)


def pmult_ms(eng, ct, pt, eager: bool = False) -> float:
    return _time(lambda: eng.pmult(ct, pt), eager)


def peak_inputs(elems: int = 8 << 20, stream_elems: int = 64 << 20,
                seed: int = 0):
    """The peak kernels' inputs on the card, from torch's generator at
    `seed`: x0 int32 [elems] residues in [0, peaks.Q) for the chains, and
    z, x int32 [stream_elems] of any bits for the stream pass."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x0 = torch.randint(0, peaks.Q, (elems,), dtype=torch.int32,
                       device="cuda", generator=gen)
    z, x = (torch.randint(-(1 << 31), 1 << 31, (stream_elems,),
                          dtype=torch.int32, device="cuda", generator=gen)
            for _ in range(2))
    return x0, z, x


def peak_rates(elems: int = 8 << 20, iters: int = 64,
               stream_elems: int = 64 << 20, dim: int = 4096,
               replays: int = 20, seed: int = 0) -> dict:
    """One sample of each peak of the roofline (roofline.py:170-267), each
    the device time of its kernel (CUDA-graph replay) on
    peak_inputs(elems, stream_elems, seed):

      peak_u32_mul_per_s       squaring links a second (csrc/peaks.cu)
      peak_shoup_modmul_per_s  Shoup products a second
      peak_mont_modmul_per_s   Montgomery products a second
      peak_bf16_flop_per_s     torch.matmul of two dim x dim bf16 matrices
                               with f32 accumulation (outside any kernel
                               of the port, as jnp.dot in roofline.py)
      hbm_stream_gb_per_s      the stream pass: two arrays of stream_elems
                               uint32 read, one written

    The chains run `iters` iterations of S links over `elems` residues."""
    x0, z, x = peak_inputs(elems, stream_elems, seed)
    links = elems * peaks.S * iters
    out = {}
    for key, op in (("peak_u32_mul_per_s", "square"),
                    ("peak_shoup_modmul_per_s", "shoup"),
                    ("peak_mont_modmul_per_s", "mont")):
        ms = device_ms(lambda: peaks.chain(x0, iters, op), calls=2,
                       replays=replays)
        out[key] = links / (ms * 1e-3)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    a = (torch.randn((dim, dim), device="cuda", generator=gen) * 1e-2).to(
        torch.bfloat16)
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False  # f32 sums
    try:
        ms = device_ms(lambda: torch.matmul(a, a), replays=replays)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = prev
    out["peak_bf16_flop_per_s"] = 2 * dim ** 3 / (ms * 1e-3)
    ms = device_ms(lambda: peaks.stream(z, x), calls=4, replays=replays)
    out["hbm_stream_gb_per_s"] = 3 * 4 * stream_elems / (ms * 1e-3) / 1e9
    return out
