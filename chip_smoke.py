#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`homulator_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper, sm_90a), `nvcc` and this checkout; imports no
JAX and nothing of the JAX package `homulator_tpu`. Every phase raises on
failure and the script then exits non-zero:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build (nvcc, one process per source) and its time, with
     ptxas's registers and spills of each instantiation of B1's, B2's,
     B4's and B6-B13's register-radix phase kernels (one for each axis
     length 2^1 .. 2^10, B4's 2^1 .. 2^8), of B18 (one for each digit
     count 1 .. 16), of the anatomy's stage kernels
     (`stages_radix`: the production form at 2^1 .. 2^10 for one run with
     either store and two runs transposed, natmul and approx at 2^1 ..
     2^8 for two runs transposed) and of B3's, B5's and
     B17's tensor-core kernels (`bconv_kernel`, `bconv_step2_kernel`,
     `planes_mm`: one for each count of k32 steps, 1 .. 4), failing if one
     is missing or takes local memory; then the native host core
     (`native.py`: g++ on `native/ckks_core.cpp`), with g++'s version and
     its time, whose keys, encodes and ciphertexts at N = 2^13 must equal
     the numpy path's bit for bit; every engine below makes its keys,
     encodes and encryptions on it;
  3. each CUDA kernel against its plain PyTorch version on the card, at the
     shapes parameter set B gives it, bit for bit (tolerance 0), with the
     device time of each (CUDA graph replay between CUDA events, so host
     overhead is excluded) and its bound (below): the NTTs (B1, B2) at the
     bases hmult and hrotate use, and at every ring degree N = 2^2 .. 2^20
     (M = 2 rows, the largest primes, rep 1 and 2: every axis length and
     launch geometry they take), the base conversion (B3) at every ModUp
     digit, ModDown and the tail, at the worst case (every input q - 1) of
     ModUp digit 0 and of the tail, on 999 coefficients (a ragged last
     tile, 4-byte loads) and at the conversions of the N = 2^13 oracle
     below, and the fused HPIP kernel (B4) at level 35 (K =
     50, digits (0,15) (15,30) (30,35)), level 20 (two digits, the last
     partial) and level 31 (a last digit of one row), and at level 35 in
     the worst case (every piece, own-row and key word q - 1), the
     piecewise route's key inner product (B18) at level 35 on one key
     switch, a batch of 8, the worst case and the hoisted route's
     automorphed pieces; ModDown's elementwise kernels (B19-B21) at level
     35 on a batch of 8, one ciphertext, the worst case and a 4-shard
     column slice, and B21's ModDown pair at levels 34 (batch 8) and 30
     and in the worst case; the phase
     kernels of the coefficient-sharded NTT (B6-B9) on
     rank 1's column slices at 4 shards (c = 64: the main rows M = 35, the
     partial digit's other rows M = 45, the specials M = 15 twice, and the
     tail's shapes) and at 2, 8, 16 and 32 shards (c = 128, 32, 16 and 8;
     M = 35: the per-limb kernels beside the packed ones at equal widths),
     and B3 once on a 4-shard slice; the limb and hybrid dispatches'
     shapes (limb rank 1 of 4: B2 on its 9 main rows, B3 of ModUp digit
     0 onto its whole 13-row ext block on a 64 x 256 gather chunk, also
     in the worst case, B1 at rep 3 over that block, B2 at rep 2 over its
     specials and last-limb slot, B3 of the tail and of ModDown onto its
     main rows on a chunk, B1 at rep 2 over them; hybrid rank (1, 1) of 2
     x 2: B3 of digit 0 onto its 26-row block on a 64 x 128 chunk, B6/B7
     at rep 3 over that block, B8/B9 over its 18 main rows); their
     lane-packed forms (B10-B13) on
     the last rank's [G, n, 128] lane groups at 8, 16 and 32 shards (c =
     32, 16, 8; k = 4, 8, 16; the main rows M = 35), and at 8 shards also
     the specials (M = 15) and the tail's last limb (M = 1) at rep = 2,
     each copy's rows padded to a multiple of k (`phase_cases`), and
     B6-B13 at their main shapes in the worst case (every input q - 1);
     the graph route's
     base-conversion step 2 (B5, on B3's tensor-core core) at ModUp digits
     0 (16 -> 35 rows, the count row included) and 2 (6 -> 45) and
     ModDown (16 -> 35), and at digit 0 in the worst case (every scaled
     word q - 1, the count row 15), and the whole graph-route conversion
     (torch step 1 and count row, then B5) against B3 on the same inputs,
     equal bits, both timed; and the shapes a data-axis shard's batch of
     two gives them (`check_data_axis_kernels`, labels "data B/d=2 ..."):
     B6-B9 at 4 coefficient shards over the main rows, a digit's other
     rows, the tail's output rows and the specials at rep 2 or 4, B1/B2
     on limb rank 1 of 4 at rep 2, 4 and 6 (ext M = 13), B3 of ModUp digit
     0 on a row slice of a [2, 36, 64, 256] gather chunk and of the tail
     on a [2, 18, 64, 256] chunk, B6-B9 on hybrid rank (1, 1) at rep 6
     and 2;
 3b. the NTT anatomy and roofline path, on no op's path: the anatomy
     kernels on set B's 35 main limbs [256, 256] (B14: copy^T, midT,
     stages1, stages2x and full, which is B1; B15: 16 stages with the
     production, natmul and approx Shoup products; B16: copy, transpose,
     mid, stages1; every stage variant on B1's register passes, and also
     in the worst case, every input q - 1), the byte-plane product B17 on
     ModUp digit 0 (16 rows
     -> 35, all 140 rows computed), each peak chain (squaring, Shoup,
     Montgomery) on the roofline's 8 Mi residues over 8 iterations of 32
     links and the stream pass over two 256 MB arrays, each against its
     plain version bit for bit (tolerance 0), with its time, bound and,
     where one PyTorch call computes the same function (a transpose, a
     copy, the bf16 matmul), that call's time; then the path itself, one
     eager call of each of these kernels on the same inputs, driven once
     with the launch counts set to 0 just before and read just after
     (every one must launch); then one short sample of each of the
     roofline's five peaks (CUDA-graph replay), printed;
  4. an independent oracle at N = 2^13 (n1 = 64 != n2 = 128), maxLevel 8,
     level 8, alpha 3 (a partial digit): the exact host engine
     (`RefCkks`) equals the port's hmult, hsquare, hrotate (steps 1 and
     -1), the fused-route hmult, hsquare and hrotate(1) and the
     graph-route (ntt_mode="jnp") hmult and hrotate (steps 1 and -1) on
     the card bit for bit, and
     conjugate equals the same engine on the CPU bit for bit; a 16 x 16
     `linalg.bsgs_matvec` on the graph route decrypts within 1e-2 of
     M @ x;
  5. parameter set B (N = 2^16, 45 main + 15 special primes) through
     `CkksEngine(device="cuda")`, level 35. The main path: hmult and
     hrotate(step 1) on the piecewise key-switch route, then both and
     hsquare with `api.USE_FUSED_HPIP` on; the launch counters are set to
     0 just before each of these five runs and read just after it, each
     run must launch every kernel of its route (the piecewise route B18
     once an op and not B4; the fused one B4 once an op and not B18), and
     the fused results must equal the piecewise ones bit for bit. Then: hmult
     and hrotate equal the plain path (the same engine on the CPU) bit for
     bit; all 32768 slots decrypt within 1e-2 of v1*v2
     (hmult), v1*v1 (hsquare) and np.roll(v1, -1) (hrotate);
     hrotate_hoisted(ct, [1, 2]) launches B18 twice and equals two single
     hrotates; the host seconds of each key. Then the graph route: a
     second engine with
     ntt_mode="jnp", given the first one's keys, runs hmult, hsquare,
     hrotate(1), conjugate, hrotate_hoisted([1, 2]), keyswitch_poly and
     rescale, each equal to the accelerated route bit for bit, each run
     with the launch counts set to 0 just before and read just after: B1,
     B2 and B5 must launch (rescale, which converts no base on either
     route: B1 and B2) and B3 and B4 must not. hadd, hsub, padd, pmult,
     cmult, cadd, rescale and mod_drop equal the CPU plain path bit for bit
     and decrypt within 1e-2 in all 32768 slots. Then the
     coefficient-sharded dispatch
     (`parallel.sharded.make_shardmap_hmult` / `make_shardmap_hrotate`,
     step 1, at their default routing, as the JAX package's): on
     `ThreadMesh(4, "cuda")` (4 shards run as 4 threads on this one card,
     each launching its own kernels on its [.., 256, 64] column slices,
     every collective a copy on the card) it takes the per-limb phase
     kernels, so B6-B9 and B3 must launch and B1, B2, B4, B10-B13 must
     not; on `ThreadMesh(8, "cuda")`, and once each on 16 and 32 shards,
     it takes the lane-packed ones, so B10-B13 and B3 must launch and B1,
     B2, B4, B6-B9 must not. Launch counts are set to 0 just before each
     run and read just after. The gathered results equal the single-device
     piecewise ones bit for bit, the bytes each shard received equal
     `ici_bytes_per_op` (at 8, 16 and 32 shards the JAX figures, padded
     rows included: 7,684,096 / 9,748,480, 4,546,560 / 5,447,680 and
     2,793,472 / 3,112,960), and the 4- and 8-shard hmult results decrypt
     within 1e-2 in all 32768 slots. Last, the batch axis: a batch of two
     hmults on a 2 x 4 mesh (`ThreadMesh(4, "cuda", data=2)`,
     `data_axis="data"`) equals the two single-device hmults bit for bit.
     Then the limb dispatch (`parallel.limb_sharded.make_limb_hmult` /
     `make_limb_hrotate`, step 1) on `ThreadMesh(2 | 4 | 8, "cuda",
     names=("limb",))`, which must launch B1, B2 and B3 and nothing else,
     and the hybrid (`make_hybrid_*`) on `ThreadMesh((2 | 4, 2), "cuda",
     names=("limb", "coeff"))`, which must launch B3 and B6-B9 and nothing
     else (launch counts set to 0 just before each run and read just
     after): the gathered results equal the single-device piecewise ones
     on the real rows, the pad rows zero; the bytes each shard received
     over its axes equal the JAX package's ici_bytes_per_op_limb /
     _hybrid (9,437,184 / 8,912,896, 14,942,208 / 13,369,344 and
     20,185,088 / 16,515,072 at 2, 4 and 8 limb shards; 14,548,992 /
     14,155,776 and 12,451,840 / 11,534,336 at 2 x 2 and 4 x 2, where
     hrotate(1)'s block map is the identity, and 18,874,368 and 13,893,632
     for hrotate(1) also run on the automorphism's gather route); the limb
     axis's collective calls equal limb_collective_count (8); the 4-shard
     limb and the 2 x 2 hybrid hmult decrypt within 1e-2 in all 32768
     slots; and a batch of two hmults on 2 data rows x 4 limb shards
     equals the single-device hmults. Last, the data axis with two
     elements a shard (`check_data_batches` on
     scripts/bench_data_axis_torch.py's cases): coeff 2 x 4, limb 2 x 4
     and hybrid 2 x (2 x 2), each at B = 2 (one element a shard) and B =
     4 (two) with the launch counts around each run; B = 4 equals four
     single-device hmults bit for bit, launches each kernel as often as
     B = 2 and makes as many collective calls on every axis (one
     element's: a shard runs its batch as one program), each shard
     receiving twice B = 2's bytes; eager and profiled device ms of each;
  6. latency (CUDA events around eager calls, median of 20 after 3 warm-up
     runs) and device time (graph replay) of hmult and hsquare, of hmult
     and hrotate on all three key-switch routes (piecewise, fused, graph);
     the eager latency of hadd, pmult, padd and rescale; the eager
     latency and device time (torch.profiler: no graph capture across the
     shard threads) of the sharded hmult and hrotate, coeff on 2, 4 and 8
     shards, limb on 2, 4 and 8, hybrid on 2 x 2 and 4 x 2 (a ThreadMesh
     of shards on this one card: not a multi-card latency);
  7. the encrypted workloads (`workloads.py`, the counterparts of
     scripts/bench_workload.py and bench_logreg.py) at set B, level 35, on
     phase 5's engine, which then holds the union of their rotation keys
     (1..7, 8, 16, .., 56 and 2^i, i < 15: 23 keys; the host seconds of
     each printed, with one key and one level-35 encode also on the numpy
     path, whose encode must give the same bits): the 64 x 64 BSGS matvec
     (g = 8: 14 key switches) and logreg (17), each on the piecewise and
     the fused route with the launch counts set to 0 just before each of
     these four runs and read just after it (B1, B2, B3 on both routes,
     B4 on the fused one only, once a fused key switch), the routes'
     outputs equal bit for bit, all 32768 slots decrypting within 1e-2 of
     M @ x or of the sigmoid polynomial, the eager latency and device
     time of each run; then both (16 x 16, g = 4) at N = 2^13 on the card,
     on both routes, equal to the CPU plain path bit for bit;
  8. the JAX package's GSPMD surface on the port's explicit dispatches,
     the CLI's remainder, the counters and the dry run, at set B, level
     35: `make_sharded_hmult` on `make_mesh((2, 2, 2))` (the hybrid
     program with a data axis: B3 and B6-B9 only) and on
     `make_mesh((2, 4))` (the limb program: B1-B3 only), a batch of two
     each, equal to the single-device hmults bit for bit, each shard's
     bytes the hybrid's or limb's count for its one element, with the
     eager latency and device time of the (2, 2, 2) run (8 shards sharing
     this card, not a multi-card latency), and on (2, 2, 2) B = 4 beside
     B = 2 as phase 5's data-axis checks; `make_coeff_sharded_ntt` on the
     35 main rows at 4 shards (B6-B9 only) and 8 shards (B10-B13 only),
     forward equal to the single-device ntt_rep and inverse to the input;
     the CLI in this process at [cluster] 4 with `--verify` for hadd,
     hsub, padd and pmult (rows over the mesh, 0 bytes a shard), hsquare
     (hmult's dispatch) and hmult `--dispatch gspmd` (the limb dispatch),
     each bit-exact to the single-device op and decrypting within 1e-2 in
     all 32768 slots; hadd, hsub, padd and pmult on 4 shards in the
     CLI's layout (n2 at level 35) equal to the single-device graph, with
     eager and profiled device ms beside the single device's eager and
     graph-replay ms; `op_cost_counters` of the seven ops (HBM_bytes,
     MEM_arg, MEM_out and MEM_temp bytes, with HBM_GBps_achieved over the
     eager median), and the same counts, but MEM_temp_bytes, on the card
     and on its CPU twin at N = 2^13 for every op; one CLI hmult run with
     `--profile`, whose Chrome trace must hold B1's launches; and
     `dryrun_multichip(8, device="cuda")` on a ThreadMesh;
  9. the op studies (`check_op_studies`; alone: python3 -c "import
     chip_smoke; chip_smoke.op_studies_main()"): parameter sets A (N =
     2^15, maxLevel 28, alpha 28: dnum 1), C (24, 6: dnum 4), D (26, 9)
     and M (set A's limbs at N = 2^16), each through CkksEngine on the
     card (host engine on the native core) at its max level and at level
     2: hmult, hrotate(1), hadd, pmult and padd, each driven with the
     launch counts around it, equal bit for bit to RefCkks on the same
     ciphertexts and within 1e-2 of the expected values in every slot
     (the key switches through the exact CRT decrypt, the others through
     RefCkks' 3-prime decode); B3 on set A's tail (31 rows in: the widest
     table) and ModUp digit 0 (28 + 1), and B4 at set A's level 28 (dnum
     1) and set C's level 24 (dnum 4), and B18 and B19-B21 at set C's
     level 24 on a batch of 8, against their plain versions, also
     in the worst case (every input q - 1); the one-program batched hmult
     (`batched_hmult_fn`) at set B, level 35, B = 1, 2, 4, 8 on the
     piecewise and the fused route, each batch equal to B single hmults
     and launching B1-B4 and B18 as often as one element, eager and
     device ms at
     B = 1 and 8, and B1-B4 on a batch of 8 against their plain versions
     (B3 on a row slice of the batch); hmult at the 36-bit parity shape
     ((56, 43, 19), recomputed by scripts/bench_parity36_torch.py's
     parity36_shape) equal to RefCkks and within 1e-2 in every slot; the
     automorphism of a rotation on [70, 256, 256] flat, staged and as
     one-hot bf16 products (scripts/bench_automorph_torch.py), equal
     bit for bit, each timed;
 10. the dispatch studies (`check_dispatch_studies`), set B, level 35:
     shard 0's program of the limb x4, coeff x4, coeff x8 (lane-packed)
     and hybrid 2 x 2 hmult and hrotate(1) alone on the card
     (`parallel.comm.StandInMesh`: every collective a local copy of the
     real result's shape; `parallel.comm.standin_programs`), each
     driven with the launch counts set to 0 just before and read just
     after (its dispatch's kernels only), its output's shape, bytes and
     collective calls on every axis equal to the ThreadMesh rank 0's of phase 5 in the same call (the bytes also
     the JAX figures, the limb axis's calls limb_collective_count),
     captured in a CUDA graph and its device ms printed beside the
     ThreadMesh's profiled device ms / ns; the kernels at the grid and
     width studies' shapes against their plain versions, bit for bit,
     with bounds: B6 and B7 at one shard (c = 256), B10 and B11 at k = 2
     (4 shards), B1 and B2 at M = 4 and 60 limbs, B3 of ModUp digit 0 at
     c = 256, 128, 64, 32; the committed anchors
     (`parallel/_scaling_measured.py`) load, were measured at set B, and
     `choose_axis` routes set B's hmult and hrotate at 2, 4 and 8 shards
     by the model, its picks and the anchors' card printed;
 11. one JSON line of per-kernel results (each kernel's times and bound at
     one shape the main path launches, named in `shape`; `max_abs_err`
     over every shape checked; `launches` summed over the main-path runs,
     per run in `launches_by_run`; the limb and hybrid shapes' numbers in
     `limb_hybrid_shapes`, phase 9's in `op_studies_shapes`, phase 10's
     in `dispatch_studies_shapes`; for the kernels of 3b every variant's
     numbers in `variants`) and phase 8's counters, then the device line
     last.

Bound of a kernel call (`benchlib.bound`): the largest of the bytes it
must move (each input read once, each output written once) over 3.35
TB/s, its int32 operations over 16.75 T/s and its tensor-core u8
operations over 1979 T/s (the dense int8 rate). The int32 rate is the
float32 peak of 67 TFLOP/s (128 lanes an SM, an FMA counted as two
operations) over four: an H100 SM has 64 int32 lanes. Operations are
counted from the shapes with a fixed cost per primitive (`benchlib.OPS`):
a Shoup product 5 (three multiplies, a subtract, an unsigned min; the
measured Shoup chain leaves room for no more), a modular add or subtract
3, a butterfly 11. B1, B2, B4, B6-B13 and the anatomy's stage variants
count their Harvey butterflies (9) and lazy products as they compute them
(`benchlib.radix_ntt_ops`, `benchlib.hpip_ops`: B4's lazy Montgomery
product-accumulate 7; `benchlib.radix_phase1_ops` for B6, B9, B10 and
B13, `benchlib.radix_phase2_ops` for B7, B8, B11 and B12 and one run of
the stages (B14's and B16's stages1), `benchlib.shoup_forms_ops` for two
(B14's stages2x, B15, one count for its three forms)). B3
counts as it computes (`bconv_bound`): step 1, the centering count, its
epilogue and the u8 products of all four planes; B5 (`step2_bound`) its
epilogue and u8 products; B17 its u8 products alone. A link of a peak
chain is counted as `PEAK_LINK_OPS` says.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

from homulator_tpu_torch import benchlib
from homulator_tpu_torch.benchlib import (
    OPS, bound, device_ms, hpip_ops, latency_ms, peak_inputs, profiled_ms,
    radix_ntt_ops, radix_phase1_ops, radix_phase2_ops, residues,
    shoup_forms_ops,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
SET_B = dict(n=1 << 16, max_level=45, alpha=15)
N16_CFG = os.path.join(ROOT, "configs", "n16.cfg")  # N = 2^16, the CLI's
LEVEL_B = 35
# B4's levels: set B's, a last digit partly full, a last digit of one row
HPIP_LEVELS = (35, 20, 31)
SCALE = float(1 << 29)
GATE = 1e-2
# int32 operations a link of a peak chain: a multiply-add (squaring), a
# Shoup or a Montgomery product
PEAK_LINK_OPS = dict(square=1, shoup=OPS["shoup"], mont=OPS["mont"])
PEAK_ITERS = 8  # chain iterations of the anatomy path's peak sample
REPLACES = {  # kernel -> (source in this repo, TPU kernel it replaces)
    "ntt_fwd": ("homulator_tpu_torch/csrc/ntt.cu",
                "homulator_tpu/ops/ntt_pallas.py:244"),
    "ntt_inv": ("homulator_tpu_torch/csrc/ntt.cu",
                "homulator_tpu/ops/ntt_pallas.py:677"),
    "bconv": ("homulator_tpu_torch/csrc/bconv.cu",
              "homulator_tpu/ops/bconv_fused.py:131"),
    "hpip": ("homulator_tpu_torch/csrc/hpip.cu",
             "homulator_tpu/ops/hpip_pallas.py:117"),
    "bconv_step2": ("homulator_tpu_torch/csrc/bconv.cu",
                    "homulator_tpu/ops/bconv_pallas.py:44"),
    "ntt_phase1": ("homulator_tpu_torch/csrc/ntt.cu",
                   "homulator_tpu/ops/ntt_pallas.py:329"),
    "ntt_phase2": ("homulator_tpu_torch/csrc/ntt.cu",
                   "homulator_tpu/ops/ntt_pallas.py:351"),
    "intt_phase2": ("homulator_tpu_torch/csrc/ntt.cu",
                    "homulator_tpu/ops/ntt_pallas.py:371"),
    "intt_phase1": ("homulator_tpu_torch/csrc/ntt.cu",
                    "homulator_tpu/ops/ntt_pallas.py:390"),
    "ntt_phase1_packed": ("homulator_tpu_torch/csrc/ntt.cu",
                          "homulator_tpu/ops/ntt_pallas.py:562"),
    "ntt_phase2_packed": ("homulator_tpu_torch/csrc/ntt.cu",
                          "homulator_tpu/ops/ntt_pallas.py:576"),
    "intt_phase2_packed": ("homulator_tpu_torch/csrc/ntt.cu",
                           "homulator_tpu/ops/ntt_pallas.py:587"),
    "intt_phase1_packed": ("homulator_tpu_torch/csrc/ntt.cu",
                           "homulator_tpu/ops/ntt_pallas.py:597"),
    # no Pallas kernel: XLA fuses the JAX package's inner product
    "ip": ("homulator_tpu_torch/csrc/ip.cu",
           "none (XLA: homulator_tpu/ops/keyswitch.py:259)"),
    # nor ModDown's elementwise steps (B19-B21, one launch count)
    "moddown": ("homulator_tpu_torch/csrc/moddown.cu",
                "none (XLA: homulator_tpu/ops/keyswitch.py:131, :394)"),
    # on no op's path: the NTT anatomy and roofline tooling
    "ntt_anatomy": ("homulator_tpu_torch/csrc/anatomy.cu",
                    "scripts/microbench_ntt.py:34"),
    "ntt_shoup_forms": ("homulator_tpu_torch/csrc/anatomy.cu",
                        "scripts/microbench_ntt2.py:109"),
    "ntt_components": ("homulator_tpu_torch/csrc/anatomy.cu",
                       "scripts/bench_ntt_variants.py:60"),
    "bconv_planes_mm": ("homulator_tpu_torch/csrc/bconv_mma.cu",
                        "scripts/roofline.py:359"),
    # the roofline's peak loops (XLA-fused on the TPU, no Pallas kernel)
    "peak_square": ("homulator_tpu_torch/csrc/peaks.cu",
                    "scripts/roofline.py:183"),
    "peak_shoup": ("homulator_tpu_torch/csrc/peaks.cu",
                   "scripts/roofline.py:194"),
    "peak_mont": ("homulator_tpu_torch/csrc/peaks.cu",
                  "scripts/roofline.py:202"),
    "peak_stream": ("homulator_tpu_torch/csrc/peaks.cu",
                    "scripts/roofline.py:257"),
}
KERNELS = tuple(REPLACES)
ANATOMY_KERNELS = KERNELS[KERNELS.index("ntt_anatomy"):]
# the limb dispatch's key switch: B1-B3 (its inner product is its own,
# parallel/limb_sharded.py::_ip_slice)
LIMB_KERNELS = ("ntt_fwd", "ntt_inv", "bconv")
PIECES_KERNELS = LIMB_KERNELS + ("ip", "moddown")
FUSED_KERNELS = LIMB_KERNELS + ("hpip", "moddown")
GRAPH_KERNELS = ("ntt_fwd", "ntt_inv", "bconv_step2")
RESCALE_KERNELS = ("ntt_fwd", "ntt_inv")
PHASE_KERNELS = ("ntt_phase1", "ntt_phase2", "intt_phase2", "intt_phase1")
PACKED_KERNELS = tuple(k + "_packed" for k in PHASE_KERNELS)
# the hybrid dispatch: the limb dispatch's inner product on column slices
HYBRID_KERNELS = PHASE_KERNELS + ("bconv",)
COEFF_KERNELS = HYBRID_KERNELS + ("ip", "moddown")
COEFF_PACKED_KERNELS = PACKED_KERNELS + ("bconv", "ip", "moddown")
NS = 4  # coefficient shards of the per-limb sharded main path
NS_PACKED = (8, 16, 32)  # shard counts that take the lane-packed kernels
# bytes a shard receives at set B, level 35, on the default (packed) route:
# ns -> (hmult, hrotate(1)), the JAX package's ici_bytes_per_op
PACKED_BYTES = {8: (7684096, 9748480), 16: (4546560, 5447680),
                32: (2793472, 3112960)}
NS_LIMB = (2, 4, 8)  # limb shards of the limb dispatch's runs
HYBRID_SHAPES = ((2, 2), (4, 2))  # (limb, coeff) shards of the hybrid's
# bytes a shard receives at set B, level 35, the JAX package's
# ici_bytes_per_op_limb: (hmult, hrotate(1)); and ici_bytes_per_op_hybrid:
# (hmult, hrotate(1) on its route, whose block map at 2 coeff shards is
# the identity (no exchange), hrotate(1) on the gather route, whose
# all_gather moves what a ppermute would: route_identity=False)
LIMB_BYTES = {2: (9437184, 8912896), 4: (14942208, 13369344),
              8: (20185088, 16515072)}
HYBRID_BYTES = {(2, 2): (14548992, 14155776, 18874368),
                (4, 2): (12451840, 11534336, 13893632)}


def ntt_cases(kt):
    """The shapes a set-B key switch at kt's level gives B1 and B2:
    {"ntt_fwd" | "ntt_inv": {label: (basis, rep)}}."""
    d0, d2 = kt.digits[0], kt.digits[2]
    both = {"main M=35 rep=2": (kt.main_nt, 2),
            "ext M=50 rep=2": (kt.ext_nt, 2),
            "special M=15 rep=2": (kt.special_nt, 2)}
    return {
        "ntt_fwd": dict(both, **{
            "digit0 other M=35 rep=1": (d0.other_nt, 1),
            "digit2 other M=45 rep=1": (d2.other_nt, 1),
            "tail out M=34 rep=2": (kt.tail.out_nt, 2)}),
        "ntt_inv": dict(both, **{
            "main M=35 rep=1": (kt.main_nt, 1),
            "tail last M=1 rep=2": (kt.tail.last_nt, 2)}),
    }


def ntt_bound(nb, rep, fwd):
    """B1 (fwd) / B2 on rep stacked copies of basis nb: x and out, the mid
    table and its Shoup table, the stage tables and q; the operations the
    register-radix kernels do (benchlib.radix_ntt_ops)."""
    M, n1, n2 = nb.q.shape[0], nb.n1, nb.n2
    n = n1 * n2
    nbytes = 4 * (2 * rep * M * n + 2 * M * n + 2 * M * (n1 + n2) + M)
    return bound(nbytes, radix_ntt_ops(rep * M, n, fwd))


def phase_bound(nb, rows, n, c, name):
    """Phase kernel `name` (B6-B13) on `rows` limb slices [n, c] over basis
    nb (rep*M, or rep*G*k with the padding rows of the lane-packed
    kernels): x and out, the [M, n, c] mid slice and its Shoup table (phase
    1: B6, B9, B10, B13), the flat stage tables and q. Operations, a row,
    as ntt_reg.cuh's register passes compute them: Harvey butterflies and,
    an element, the lazy mid (B6, B10) or mid_inv (B9, B13) product and a
    conditional subtract (benchlib.radix_phase1_ops), or the conditional
    subtracts of phase 2 (benchlib.radix_phase2_ops: two forward, B7 and
    B11, one inverse, B8 and B12)."""
    M = nb.q.shape[0]
    mid = name.startswith(("ntt_phase1", "intt_phase1"))
    nbytes = 4 * (2 * rows * n * c + int(mid) * 2 * M * n * c
                  + 2 * M * n + M)
    ops = (radix_phase1_ops(rows, n, c) if mid else
           radix_phase2_ops(rows, n, c, name.startswith("ntt_phase")))
    return bound(nbytes, ops)


def phase_cases(dc):
    """The shapes chip_smoke checks the phase kernels at (set B, level
    35): {kernel: {label: (basis, rep, worst)}}. B6-B9 on rank 1's column
    slices at 4 shards (c = 64: the main rows M = 35, the partial digit's
    other rows M = 45, the specials M = 15 twice, and the tail's shapes)
    and at 2, 8, 16 and 32 shards (c = 128, 32, 16 and 8; M = 35: the
    per-limb kernels beside the packed ones at equal widths); B10-B13 on
    the last rank's lane groups at 8, 16 and 32 shards (c = 32, 16, 8; k =
    4, 8, 16; M = 35), and at 8 shards also the specials (M = 15) and the
    tail's last limb (M = 1) at rep = 2, each copy's rows padded to a
    multiple of k. `worst`: every input q - 1, each phase at its main
    shape (ns=4 for B6-B9, ns=8 for B10-B13)."""
    k4 = dc.keyswitch_tables(LEVEL_B, shard=(1, NS))

    def main_nt(ns):
        return dc.keyswitch_tables(LEVEL_B, shard=(1, ns)).main_nt

    common = {  # label -> (basis, rep, worst)
        "ns=4 c=64 main M=35 rep=1": (k4.main_nt, 1, False),
        "ns=4 c=64 digit2 other M=45 rep=1": (k4.digits[2].other_nt, 1,
                                              False),
        "ns=4 c=64 special M=15 rep=2": (k4.special_nt, 2, False),
        "ns=2 c=128 main M=35 rep=1": (main_nt(2), 1, False),
        # two, one and half a 16-column tile a limb
        "ns=8 c=32 main M=35 rep=1": (main_nt(8), 1, False),
        "ns=16 c=16 main M=35 rep=1": (main_nt(16), 1, False),
        "ns=32 c=8 main M=35 rep=1": (main_nt(32), 1, False),
    }
    fwd = dict(common, **{
        "ns=4 c=64 tail out M=34 rep=2": (k4.tail.out_nt, 2, False)})
    inv = dict(common, **{
        "ns=4 c=64 tail last M=1 rep=2": (k4.tail.last_nt, 2, False)})
    packed = {}
    for ns in NS_PACKED:
        kt = dc.keyswitch_tables(LEVEL_B, shard=(ns - 1, ns), packed=True)
        tag = f"ns={ns} c={kt.main_nt.n2 // ns} k={kt.main_nt.pack}"
        packed[f"{tag} main M=35 rep=1"] = (kt.main_nt, 1, False)
        if ns == NS_PACKED[0]:
            packed[f"{tag} special M=15 rep=2"] = (kt.special_nt, 2, False)
            packed[f"{tag} tail last M=1 rep=2"] = (kt.tail.last_nt, 2,
                                                    False)
            worst_packed = (f"{tag} main M=35 rep=1 worst (all q-1)",
                            (kt.main_nt, 1, True))
    worst = {"ns=4 c=64 main M=35 rep=1 worst (all q-1)": (k4.main_nt, 1,
                                                           True)}
    fwd_worst, inv_worst = dict(fwd, **worst), dict(inv, **worst)
    packed_worst = dict(packed, **dict([worst_packed]))
    return {"ntt_phase1": fwd_worst, "ntt_phase2": fwd_worst,
            "intt_phase2": inv_worst, "intt_phase1": inv_worst,
            "ntt_phase1_packed": packed_worst,
            "ntt_phase2_packed": packed_worst,
            "intt_phase2_packed": packed_worst,
            "intt_phase1_packed": packed_worst}


def phase_input(np, torch, name, nb, rep, worst, rng):
    """The input of phase kernel `name` on rep copies of basis nb, sharded
    (nb.shard = (rank, ns)): [rep*M, n, c] residues (n1 rows for B6, B9,
    B10, B13, else n2; c = the other axis / ns), all q - 1 if `worst`;
    for the packed kernels lane-packed into [rep*G, n, k*c], each copy's
    rows padded (ops/ntt.py::_pack_pad)."""
    from homulator_tpu_torch.ops import ntt as ntt_mod

    along_n1 = name.startswith(("ntt_phase1", "intt_phase1"))
    n, other = (nb.n1, nb.n2) if along_n1 else (nb.n2, nb.n1)
    q = np.tile(nb.q.cpu().numpy(), rep)
    shape = (len(q), n, other // nb.shard[1])
    x = (torch.from_numpy(np.broadcast_to(q[:, None, None] - 1, shape)
                          .astype(np.int32)).cuda()
         if worst else residues(q, shape, rng))
    return ntt_mod._pack_pad(x, nb.pack, rep) if nb.pack else x


def bconv_bound(nd, m_out, center, n):
    """B3 as csrc/bconv.cu computes it: nd limbs in, m_out out, the step-1
    pair and in_q, the table (a byte an entry), horner_sh and out_q; the
    int32 operations of step 1 (a Shoup product a row), the centering
    count (a compare and an add a row) and the epilogue
    (OPS["planes_reduce"] an output; the byte planes are the words
    themselves), and the u8 tensor-core products of all 4 m_out plane
    rows."""
    ndt = nd + int(center)
    nbytes = (4 * (nd * n + m_out * n + 3 * nd + 2 * m_out)
              + (4 * m_out) * (4 * ndt))
    ops = n * (nd * OPS["shoup"] + int(center) * 2 * nd
               + m_out * OPS["planes_reduce"])
    return bound(nbytes, ops, 2 * (4 * m_out) * (4 * ndt) * n)


def step2_bound(nd, m_out, n):
    """B5 as csrc/bconv.cu computes it, B3 without step 1 and the count:
    nd rows in (the count row included), m_out out, the table (a byte an
    entry), horner_sh and out_q; the epilogue's int32 operations
    (OPS["planes_reduce"] an output) and the u8 tensor-core products of
    all 4 m_out plane rows."""
    nbytes = 4 * (nd * n + m_out * n + 2 * m_out) + (4 * m_out) * (4 * nd)
    return bound(nbytes, n * m_out * OPS["planes_reduce"],
                 2 * (4 * m_out) * (4 * nd) * n)


def hpip_bound(kt, batch=1):
    """B4 at kt's level on a batch of `batch` key switches under one key:
    each element's converted rows, own rows and output, the key rows read
    once (beta x 2 x K), the ext basis's mid and stage tables once (the
    phase-A scratch is not counted: the least the card could move); the
    operations csrc/hpip.cu does, an element (benchlib.hpip_ops: the
    converted rows' NTTs in Harvey butterflies, the lazy Montgomery
    product-accumulates, one reduction an output word)."""
    nt = kt.ext_nt
    n1, n2 = nt.n1, nt.n2
    n = n1 * n2
    K = nt.q.shape[0]
    beta = len(kt.digits)
    conv_rows = sum(K - (dt.hi - dt.lo) for dt in kt.digits)
    nbytes = 4 * (batch * (conv_rows * n + kt.level * n + 2 * K * n)
                  + beta * 2 * K * n + 2 * K * n + 2 * K * (n1 + n2) + 2 * K)
    return bound(nbytes, batch * hpip_ops(conv_rows, K, beta, n))


def ip_bound(kt, batch=1):
    """B18 at kt's level on a batch of `batch` key switches under one key:
    each element's terms (its converted rows and own rows, beta x K rows)
    read and both accumulators written, the key rows (beta x 2 x K) read
    once, q and qinv; beta x 2 x K rows of lazy Montgomery
    product-accumulates and one conditional subtract an output word, an
    element."""
    n = kt.ext_nt.n1 * kt.ext_nt.n2
    K = kt.ext_nt.q.shape[0]
    beta = len(kt.digits)
    nbytes = 4 * (batch * (beta * K * n + 2 * K * n) + beta * 2 * K * n
                  + 2 * K)
    return bound(nbytes, batch * (beta * 2 * K * n * OPS["lazy_mont_mac"]
                                  + 2 * K * n * OPS["csub"]))


def anatomy_bound(M, n1, n2, passes, mid):
    """B14-B16 on M limbs [n1, n2]: x read and the output written, the mid
    pair (mid variants), the stage-1 pair (stage variants) and q; n1 * n2
    mid products, a limb (mid variants), or the register passes'
    operations (stage variants: one run as B1's phase B,
    benchlib.radix_phase2_ops, two as benchlib.shoup_forms_ops, one count
    for B15's three forms)."""
    nbytes = 4 * (2 * M * n1 * n2 + int(mid) * 2 * M * n1 * n2
                  + int(passes > 0) * 2 * M * n1 + int(mid or passes > 0) * M)
    runs = {1: radix_phase2_ops, 2: shoup_forms_ops}
    ops = ((runs[passes](M, n1, n2) if passes else 0)
           + int(mid) * M * n1 * n2 * OPS["shoup"])
    return bound(nbytes, ops)


def planes_mm_bound(nd, m_out, n):
    """B17: x [nd, n] read, D_0 [m_out, n] written, the bf16 table read;
    2 * (4 m_out) * (4 nd) * n u8 tensor-core operations (all 4 m_out
    rows, as the kernel computes them); no int32 work."""
    return bound(4 * (nd + m_out) * n + 2 * (4 * m_out) * (4 * nd), 0,
                 2 * (4 * m_out) * (4 * nd) * n)


def compare(torch, name, label, kernel, plain, bnd, results, library=None,
            **timing):
    """Run kernel() and plain() on the card, require equal bits, time
    both (and library(), one PyTorch call computing the same function,
    when given; device_ms takes `timing`), and record (label, err, ms,
    plain_ms, bound_ms, bound_by, library_ms)."""
    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError(f"{name} {label}: differs by {err}")
    ms = device_ms(kernel, **timing)
    plain_ms = device_ms(plain, **timing)
    lib_ms = device_ms(library, **timing) if library else None
    print(f"# {name} {label}: bit-exact (tolerance 0), kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
          + (f", library {lib_ms:.4f} ms" if library else ""))
    results[name].append((label, err, ms, plain_ms) + bnd + (lib_ms,))


# kernel templates whose every instantiation chip_smoke holds to no local
# memory: name -> instantiations (B1/B2 and B6-B13: axis length 2^L, L =
# 1..10; B4's two phases: L = 1..8; the anatomy's stage kernels: L =
# 1..10 in the production form at (runs, store) (1, transposed), (1,
# row-major) and (2, transposed), L = 1..8 in natmul and approx at (2,
# transposed); B3/B5/B17: k32 steps 1..4; B18: digits 1..16)
CHECKED_INSTANTIATIONS = {"ntt_fwd_radix_a": 10, "ntt_fwd_radix_b": 10,
                          "ntt_inv_radix_a": 10, "ntt_inv_radix_b": 10,
                          "hpip_radix_a": 8, "hpip_radix_b": 8,
                          "ntt_phase1_radix": 10, "packed_phase1_radix": 10,
                          "ntt_phase2_radix": 10, "packed_phase2_radix": 10,
                          "ntt_iphase2_radix": 10,
                          "packed_iphase2_radix": 10,
                          "ntt_iphase1_radix": 10,
                          "packed_iphase1_radix": 10,
                          "stages_radix": 3 * 10 + 2 * 8, "bconv_kernel": 4,
                          "bconv_step2_kernel": 4, "planes_mm": 4,
                          "ip_kernel": 16}
# the Shoup forms in the stage kernels' mangled names
SHOUP_FORMS = ("ShoupLazy", "ShoupNatmul", "ShoupApprox")


def kernel_registers(log_text):
    """ptxas's registers and local-memory bytes (stack frame, spill stores
    and loads) of each instantiation of CHECKED_INSTANTIATIONS' kernels in
    nvcc's log: {kernel: {template arguments: (registers, local bytes)}},
    the arguments L or KS, or (L, Shoup form, runs, "T" transposed or "R"
    row-major) for stages_radix."""
    import re

    names = "|".join(CHECKED_INSTANTIATIONS)
    forms = "|".join(SHOUP_FORMS)
    out, entry, spill = {}, None, 0
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            m = re.search(rf"\d({names})ILi(\d+)E"
                          rf"(?:N2hk\d+({forms})ELi(\d+)ELb([01])E)?", line)
            arg = m and (int(m.group(2)) if m.group(3) is None
                         else (int(m.group(2)), m.group(3),
                               int(m.group(4)), "RT"[int(m.group(5))]))
            entry, spill = (m.group(1), arg) if m else None, 0
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            spill = sum(int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.setdefault(entry[0], {})[entry[1]] = (int(m.group(1)), spill)
            entry = None
    return out


def check_radix_sweep(np, torch, get_params):
    """B1 and B2 against their plain versions, bit for bit, at every ring
    degree N = 2^2 .. 2^20 (n1 x n2 from 2 x 2 to 1024 x 1024: every axis
    length, so every kernel instantiation, and the narrow tiles of small
    n), on M = 2 rows (the largest prime and the first main), rep 1 and
    2."""
    from homulator_tpu_torch.context import DeviceContext
    from homulator_tpu_torch.ops import ntt_kernels
    from homulator_tpu_torch.ops.ntt import intt_plain, ntt_plain

    shapes = []
    for logn in range(2, 21):
        p = get_params(n=1 << logn, max_level=2, alpha=1)
        nb = DeviceContext(p, "cuda").ntt_basis((p.max_level, 0))
        for rep in (1, 2):
            q = np.tile(nb.q.cpu().numpy(), rep)
            for kernel, plain, shape in (
                    (ntt_kernels.ntt_fwd, ntt_plain, (nb.n1, nb.n2)),
                    (ntt_kernels.ntt_inv, intt_plain, (nb.n2, nb.n1))):
                x = residues(q, (len(q),) + shape, logn)
                if not torch.equal(kernel(x, nb, rep), plain(x, nb, rep)):
                    raise AssertionError(f"{kernel.__name__} at N=2^{logn} "
                                         f"rep={rep} != its plain version")
        shapes.append(f"{nb.n1}x{nb.n2}")
    print(f"# ntt_fwd, ntt_inv at N=2^2..2^20 ({', '.join(shapes)}), M=2, "
          "rep 1 and 2: bit-exact (tolerance 0)")


def bconv_cases(kt, prefix=""):
    """B3's conversions at kt's level: {label: (input primes, (s, s_sh,
    in_q, mat, mat_mma, horner_sh, out_q), center)}: every ModUp digit,
    the fused tail, ModDown."""
    cases = {}
    for d, dt in enumerate(kt.digits):
        label = f"modup digit{d} {dt.hi - dt.lo}+1->{dt.mat.shape[0]}"
        cases[prefix + label] = (
            dt.in_q, (dt.step1, dt.step1_sh, dt.in_q, dt.mat, dt.mat_mma,
                      dt.horner_sh, dt.other_nt.q), True)
    tt = kt.tail
    cases[f"{prefix}tail {tt.in_q.shape[0]}->{tt.mat.shape[0]}"] = (
        tt.in_q, (tt.one, tt.one_sh, tt.in_q, tt.mat, tt.mma, tt.horner_sh,
                  tt.out_nt.q), False)
    label = f"moddown {kt.md_s1.shape[0]}+1->{kt.md_mat.shape[0]}"
    cases[prefix + label] = (
        kt.special_nt.q, (kt.md_s1, kt.md_s1_sh, kt.special_nt.q, kt.md_mat,
                          kt.md_mma, kt.md_horner_sh, kt.main_nt.q), True)
    return cases


def check_bconv(torch, label, x, tabs, center, results, **timing):
    """B3 against bconv_plain on x ([nd, R, C], or a batch [B, nd, R, C]),
    bit for bit, timed (device_ms takes `timing`), with its bound."""
    from homulator_tpu_torch.ops.bconv_fused import bconv_fused, bconv_plain

    s, s_sh, iq, mat, tab, hsh, out_q = tabs
    nd = x.shape[-3]
    compare(torch, "bconv", label,
            lambda: bconv_fused(x, s, s_sh, iq, mat, tab, hsh, out_q,
                                center=center),
            lambda: bconv_plain(x, s, s_sh, iq, mat, out_q, center),
            bconv_bound(nd, out_q.shape[0], center, x.numel() // nd),
            results, **timing)


def check_kernels(np, torch, dc, rng, results, get_params):
    """Phase 3: every kernel vs its plain version at the set-B shapes."""
    from homulator_tpu_torch.context import DeviceContext
    from homulator_tpu_torch.ops import ntt_kernels
    from homulator_tpu_torch.ops.ntt import intt_plain, ntt_plain

    kt = dc.keyswitch_tables(LEVEL_B)
    n1, n2 = dc.params.ntt.n1, dc.params.ntt.n2
    cases = ntt_cases(kt)
    for name, kernel, plain, shape in (
            ("ntt_fwd", ntt_kernels.ntt_fwd, ntt_plain, (n1, n2)),
            ("ntt_inv", ntt_kernels.ntt_inv, intt_plain, (n2, n1))):
        for label, (nb, rep) in cases[name].items():
            q = np.tile(nb.q.cpu().numpy(), rep)
            x = residues(q, (len(q),) + shape, rng)
            compare(torch, name, label,
                    lambda: kernel(x, nb, rep), lambda: plain(x, nb, rep),
                    ntt_bound(nb, rep, name == "ntt_fwd"), results)

    # B3: set B's five main-path conversions; the worst case (every
    # input q - 1: the tail's words enter the product as they are, nd = 18;
    # ModUp digit 0 through step 1); a ragged edge (ncoef = 999, 4-byte
    # loads, the last warp tile part full); the N = 2^13 oracle's shapes
    cases = bconv_cases(kt)
    for label, (in_q, tabs, center) in cases.items():
        x = residues(in_q, (in_q.shape[0], n1, n2), rng)
        check_bconv(torch, label, x, tabs, center, results)
    for label in (next(iter(cases)), next(k for k in cases if "tail" in k)):
        in_q, tabs, center = cases[label]
        worst = (in_q - 1).view(-1, 1, 1).expand(-1, n1, n2).contiguous()
        check_bconv(torch, f"{label} worst case (x = q-1)", worst, tabs,
                    center, results)
    in_q, tabs, center = cases[next(iter(cases))]
    check_bconv(torch, "modup digit0 ragged ncoef=999",
                residues(in_q, (in_q.shape[0], 27, 37), rng), tabs, center,
                results)
    pm = get_params(n=1 << 13, max_level=8, alpha=3)
    for label, (in_q, tabs, center) in bconv_cases(
            DeviceContext(pm, "cuda").keyswitch_tables(8),
            "N=2^13 l8 a3 ").items():
        x = residues(in_q, (in_q.shape[0], pm.ntt.n1, pm.ntt.n2), rng)
        check_bconv(torch, label, x, tabs, center, results)

    # B4 at each of HPIP_LEVELS; then the worst case at level 35
    for level, wc in [(lv, False) for lv in HPIP_LEVELS] + [(LEVEL_B, True)]:
        check_hpip(np, torch, dc, level, wc, rng, results)
    # B18 at level 35: one key switch, a batch of 8, the worst case, the
    # hoisted route's automorphed pieces
    for batch, wc, hoisted in ((None, False, False), (8, False, False),
                               (None, True, False), (None, False, True)):
        check_ip(np, torch, dc, LEVEL_B, wc, rng, results, batch=batch,
                 hoisted=hoisted)
    # B19-B21: the ModDown + rescale at level 35 on a batch of 8 (the
    # setB.hmult.b8 cell's), one ciphertext, the worst case and a 4-shard
    # column slice; the ModDown pair at level 34 on a batch of 8 (HELR's
    # batched rotations), at level 30 alone, and in the worst case
    for batch, wc, level, pair, cols in (
            (8, False, LEVEL_B, False, None), (None, False, LEVEL_B, False,
                                               None),
            (None, True, LEVEL_B, False, None), (2, False, LEVEL_B, False, 4),
            (8, False, 34, True, None), (None, False, 30, True, None),
            (2, True, LEVEL_B, True, None)):
        check_moddown(np, torch, dc, level, wc, rng, results, batch=batch,
                      pair=pair, cols=cols)


def hpip_inputs(np, torch, dc, level, worst, rng, batch=None):
    """B4's inputs at dc's `level`: random pieces, own rows and a random
    Montgomery-form key [dnum, 2, K_full, n2, n1] over the specials-first
    primes, or (worst) every piece, own-row and key word q - 1 (the
    largest term and product the lazy ranges take); with batch B, B
    elements (pieces [B, rows_d, n1, n2], d_eval [B, level, n2, n1])
    under the one key. Returns (convs, d_eval, key, kt)."""
    p = dc.params
    n1, n2 = p.ntt.n1, p.ntt.n2
    kt = dc.keyswitch_tables(level)

    def make(q, shape):  # row i of the first axis mod q[i], or q[i] - 1
        if isinstance(q, torch.Tensor):
            q = q.cpu().numpy()
        q = np.asarray(q, dtype=np.int64)
        if not worst:
            return residues(q, shape, rng)
        return torch.from_numpy((q - 1).astype(np.int32)).cuda().view(
            (-1,) + (1,) * (len(shape) - 1)).expand(shape).contiguous()

    def elems(q, shape):
        if batch is None:
            return make(q, shape)
        return torch.stack([make(q, shape) for _ in range(batch)])

    key_q = np.concatenate([p.q_arr[p.max_level:], p.q_arr[:p.max_level]])
    key = make(np.tile(key_q, 2 * p.dnum),
               (2 * p.dnum * p.num_primes, n2, n1)).view(
                   p.dnum, 2, p.num_primes, n2, n1)
    convs = [elems(dt.other_nt.q, (dt.other_nt.q.shape[0], n1, n2))
             for dt in kt.digits]
    return convs, elems(kt.main_nt.q, (level, n2, n1)), key, kt


def check_hpip(np, torch, dc, level, worst, rng, results, prefix="",
               batch=None, **timing):
    """B4 against hpip_plain on hpip_inputs' inputs at dc's `level`, bit
    for bit, timed (device_ms takes `timing`), with its bound."""
    from homulator_tpu_torch.ops.hpip import hpip_kernel, hpip_plain

    convs, d_eval, key, kl = hpip_inputs(np, torch, dc, level, worst, rng,
                                         batch)
    spans = " ".join(f"({dt.lo},{dt.hi})" for dt in kl.digits)
    compare(torch, "hpip",
            f"{prefix}level {level} K={kl.ext_nt.q.shape[0]} digits {spans}"
            + (" worst case (all q-1)" if worst else ""),
            lambda: hpip_kernel(convs, d_eval, key, kl),
            lambda: hpip_plain(convs, d_eval, key, kl),
            hpip_bound(kl, batch or 1), results, **timing)


def check_ip(np, torch, dc, level, worst, rng, results, prefix="",
             batch=None, hoisted=False, **timing):
    """B18 against ip_plain at dc's `level`, bit for bit, timed, with its
    bound: hpip_inputs' pieces taken as eval-domain rows (n1 = n2 at the
    sets it runs on), or (hoisted) the pieces and own rows after the
    automorphism of step 1, as the hoisted route passes them."""
    from homulator_tpu_torch.ops.automorph import automorph_eval
    from homulator_tpu_torch.ops.ip import ip_kernel, ip_plain

    convs, d_eval, key, kl = hpip_inputs(np, torch, dc, level, worst, rng,
                                         batch)
    convs = [c.view(c.shape[:-2] + d_eval.shape[-2:]) for c in convs]
    if hoisted:
        perm = dc.automorph_perm(dc.params.galois_elt(1))
        convs = [automorph_eval(c, perm) for c in convs]
        d_eval = automorph_eval(d_eval, perm)
    spans = " ".join(f"({dt.lo},{dt.hi})" for dt in kl.digits)
    compare(torch, "ip",
            f"{prefix}level {level} K={kl.ext_nt.q.shape[0]} digits {spans}"
            + (f" batch {batch}" if batch else "")
            + (" worst case (all q-1)" if worst else "")
            + (" automorphed (hoisted)" if hoisted else ""),
            lambda: ip_kernel(convs, d_eval, key, kl),
            lambda: ip_plain(convs, d_eval, key, kl),
            ip_bound(kl, batch or 1), results, **timing)


def check_moddown(np, torch, dc, level, worst, rng, results, prefix="",
                  batch=None, pair=False, cols=None, **timing):
    """B19-B21 against their plain versions (run on the card) at dc's
    `level`, bit for bit, timed, each with its bound: md_zl, md_head and
    md_tail with the P d term, as the hmult's ModDown + rescale runs them
    (pair: md_tail alone with P^-1, a rotation's ModDown pair), on
    random residues or (worst) every input q - 1; the accumulators as
    int32 views of one [B, 2, alpha+level, R, C] tensor (B18's), d int64.
    cols = ns: on one shard's [R, C/ns] column slice."""
    from homulator_tpu_torch.ops import moddown as md
    from homulator_tpu_torch.stats import _nbytes

    kt = dc.keyswitch_tables(level)
    tt, lm1 = kt.tail, level - 1
    alpha = kt.special_nt.q.shape[0]
    R, C = dc.params.ntt.n2, dc.params.ntt.n1 // (cols or 1)
    lead = () if batch is None else (batch,)

    def make(q, shape):  # rows along axis -3 mod q, or q - 1
        q = q.cpu().numpy().astype(np.int64)
        if not worst:
            x = residues(np.tile(q, math.prod(shape[:-3])),
                         (math.prod(shape[:-2]),) + shape[-2:], rng)
            return x.view(shape)
        return torch.from_numpy((q - 1).astype(np.int32)).cuda().view(
            -1, 1, 1).expand(shape).contiguous()

    acc = make(kt.ext_nt.q, lead + (2, alpha + level, R, C))
    mains = (acc[..., 0, alpha:, :, :], acc[..., 1, alpha:, :, :])
    ds = tuple(make(kt.main_nt.q, lead + (level, R, C)).long()
               for _ in (0, 1))
    pl = R * C * 2 * (batch or 1)  # words of one row of every (b, k)

    def bnd(traffic, ops):
        reads, nbytes = traffic
        return bound(sum(_nbytes(t) for t in reads) + nbytes, ops * pl)

    what = (f"{prefix}level {level}" + (f" batch {batch}" if batch else "")
            + (f" 1/{cols} columns" if cols else "")
            + (" worst case (all q-1)" if worst else ""))
    shoup, add = OPS["shoup"], OPS["modadd"]
    if pair:
        e = make(kt.main_nt.q, lead + (2, level, R, C))
        args = (mains, e, kt.main_nt.q, kt.pinv, kt.pinv_sh)
        compare(torch, "moddown", f"md_tail pair {what}",
                lambda: md.tail_kernel(*args), lambda: md.tail_plain(*args),
                bnd(md.tail_traffic(*args), level * (shoup + add)), results,
                **timing)
        return
    compare(torch, "moddown", f"md_zl {what}",
            lambda: md.zl_kernel(*mains, *ds, kt),
            lambda: md.zl_plain(*mains, *ds, kt),
            bnd(md.zl_traffic(*mains, *ds, kt), shoup + add), results,
            **timing)
    b = make(kt.special_nt.q, lead + (2, alpha, R, C))
    zl = make(kt.main_nt.q[lm1:level], lead + (2, 1, R, C)).squeeze(-3)
    compare(torch, "moddown", f"md_head {what}",
            lambda: md.head_kernel(b, zl, kt),
            lambda: md.head_plain(b, zl, kt),
            bnd(md.head_traffic(b, zl, kt),
                alpha * (shoup + OPS["lazy_shoup"] + OPS["csub"] + 1)
                + OPS["lazy_shoup"] + 2 * OPS["csub"] + shoup + add + 1),
            results, **timing)
    e = make(tt.out_nt.q, lead + (2, lm1, R, C))
    args = (mains, e, tt.out_nt.q, tt.pq_inv, tt.pq_inv_sh, ds, tt.p_modq,
            tt.p_modq_sh)
    compare(torch, "moddown", f"md_tail rescale {what}",
            lambda: md.tail_kernel(*args), lambda: md.tail_plain(*args),
            bnd(md.tail_traffic(*args), lm1 * (2 * shoup + 2 * add)),
            results, **timing)


def check_step2_kernel(np, torch, dc, rng, results):
    """Phase 3, the graph route's conversion: B5 vs its plain version at
    the set-B shapes it takes (ModUp digits 0 and 2, ModDown) and at digit
    0 in the worst case (every scaled word q - 1, the count row nd - 1),
    and the whole graph-route conversion (step 1 and the count row as
    torch ops, then B5) vs B3 on the same inputs: equal bits, both timed
    (the A/B of the two routes' conversions). Runs after check_kernels,
    whose B3 rows at these conversions it prints beside B5's."""
    from homulator_tpu_torch.ops.bconv import (
        bconv_step1_centered, bconv_step2, bconv_step2_plain,
    )
    from homulator_tpu_torch.ops.bconv_fused import bconv_fused

    kt = dc.keyswitch_tables(LEVEL_B)
    n1, n2 = dc.params.ntt.n1, dc.params.ntt.n2
    d0, d2 = kt.digits[0], kt.digits[2]
    cases = {  # label -> (step-1 pair, input primes, matrix, table and
        # horner_sh, out q)
        f"modup digit{d}": ((dt.step1, dt.step1_sh), dt.in_q,
                            (dt.mat, dt.mat_mma, dt.horner_sh),
                            dt.other_nt.q)
        for d, dt in ((0, d0), (2, d2))}
    cases["moddown"] = ((kt.md_s1, kt.md_s1_sh), kt.special_nt.q,
                        (kt.md_mat, kt.md_mma, kt.md_horner_sh),
                        kt.main_nt.q)
    for label, ((s, s_sh), iq, (mat, tab, hsh), out_q) in cases.items():
        nd, m_out = iq.shape[0], out_q.shape[0]
        x = residues(iq, (nd, n1, n2), rng)

        def step1_rows():  # torch step 1 and the centering count row
            return bconv_step1_centered(x, s, s_sh, iq)

        xhat = step1_rows().to(torch.int32)
        full = f"{label} {nd + 1}->{m_out}"
        for lab, xh in ((full, xhat), (f"{full} worst case (xhat = q-1, "
                                       f"count {nd})", None)):
            if xh is None:
                if label != "modup digit0":
                    continue
                xh = torch.cat([(iq - 1).view(-1, 1, 1).expand(-1, n1, n2),
                                torch.full_like(xhat[:1], nd)]).contiguous()
            compare(torch, "bconv_step2", lab,
                    lambda: bconv_step2(xh, mat, tab, hsh, out_q),
                    lambda: bconv_step2_plain(xh, mat, out_q),
                    step2_bound(nd + 1, m_out, n1 * n2), results)

        def graph_conv():
            return bconv_step2(step1_rows(), mat, tab, hsh, out_q)

        def b3():
            return bconv_fused(x, s, s_sh, iq, mat, tab, hsh, out_q,
                               center=True)

        if not torch.equal(graph_conv(), b3()):
            raise AssertionError(f"{full}: graph-route conversion != B3")
        b3_row = next(r for r in results["bconv"]
                      if r[0] == f"{label} {nd}+1->{m_out}")
        b5_row = next(r for r in results["bconv_step2"] if r[0] == full)
        print(f"# A/B {full}: B5 {b5_row[2]:.4f} ms (step 2 only); graph "
              f"conversion (torch step 1 + count row + B5) "
              f"{device_ms(graph_conv):.4f} ms; B3 (steps 1 and 2, "
              f"centering fused) {b3_row[2]:.4f} ms, {device_ms(b3):.4f} ms "
              "again; equal bits")


def check_phase_kernels(np, torch, dc, rng, results):
    """Phase 3, sharded: B6-B13 vs their plain versions at phase_cases'
    shapes, and B3 on a 4-shard slice."""
    from homulator_tpu_torch.ops import ntt as ntt_mod
    from homulator_tpu_torch.ops import ntt_kernels

    for name, cases in phase_cases(dc).items():
        kernel = getattr(ntt_kernels, name)
        plain = getattr(ntt_mod, name + "_plain")
        for label, (nb, rep, worst) in cases.items():
            x = phase_input(np, torch, name, nb, rep, worst, rng)
            c = x.shape[2] // (nb.pack or 1)
            rows = x.shape[0] * (nb.pack or 1)
            compare(torch, name, label,
                    lambda: kernel(x, nb, rep), lambda: plain(x, nb, rep),
                    phase_bound(nb, rows, x.shape[1], c, name), results)
    n1, n2 = dc.params.ntt.n1, dc.params.ntt.n2
    k4 = dc.keyswitch_tables(LEVEL_B, shard=(1, NS))
    label, (in_q, tabs, center) = next(iter(bconv_cases(k4, "ns=4 c=64 ")
                                            .items()))
    check_bconv(torch, label,
                residues(in_q, (in_q.shape[0], n1, n2 // NS), rng), tabs,
                center, results)


def check_limb_kernels(np, torch, dc, rng, results):
    """Phase 3, the shapes of the limb and hybrid dispatches (set B, level
    35; parallel/limb_sharded.py's per-shard tables). On limb rank 1 of 4
    (sm = 9 main rows, sa = 4 specials, its ext block B = 13 rows, G = 4
    gather chunks of n1/G = 64 rows): B2 on its main rows, B3 of ModUp
    digit 0 onto its whole ext block (specials and mains, the digit's own
    rows included) on a chunk, also in the worst case (x = q - 1), B1 at
    rep = beta = 3 over its ext basis, B2 at rep 2 over its [specials,
    last-limb slot] basis, B3 of the tail and of ModDown onto its main
    rows on a chunk, B1 at rep 2 over its main rows. On hybrid rank (1, 1)
    of 2 x 2 (B = 26, 128 columns): B3 of digit 0 on a chunk, B6 and B7 at
    rep 3 over its ext basis, B8 and B9 over its main rows."""
    from homulator_tpu_torch.ops import ntt as ntt_mod
    from homulator_tpu_torch.ops import ntt_kernels
    from homulator_tpu_torch.parallel.limb_sharded import build_limb_tables

    n1, n2 = dc.params.ntt.n1, dc.params.ntt.n2
    T = build_limb_tables(dc, LEVEL_B, 4, 1)
    tag = "limb ns=4 rank1"
    beta = len(T.digits)
    for name, nb, what, rep in (
            ("ntt_inv", T.main_nt, "main", 1),
            ("ntt_fwd", T.ext_nt, "ext", beta),
            ("ntt_inv", T.tailzl_nt, "tailzl", 2),
            ("ntt_fwd", T.main_nt, "main", 2)):
        fwd = name == "ntt_fwd"
        q = np.tile(nb.q.cpu().numpy(), rep)
        x = residues(q, (len(q),) + ((n1, n2) if fwd else (n2, n1)), rng)
        kernel = ntt_kernels.ntt_fwd if fwd else ntt_kernels.ntt_inv
        plain = ntt_mod.ntt_plain if fwd else ntt_mod.intt_plain
        compare(torch, name, f"{tag} {what} M={nb.q.shape[0]} rep={rep}",
                lambda: kernel(x, nb, rep), lambda: plain(x, nb, rep),
                ntt_bound(nb, rep, fwd), results)
    ch = n1 // T.gchunks
    d0 = T.digits[0]
    nd, B, sm, alpha = d0.hi - d0.lo, T.sa + T.sm, T.sm, T.alpha
    cases = {
        f"{tag} modup digit0 {nd}+1->{B} chunk {ch}x{n2}": (
            d0.in_q, (d0.step1, d0.step1_sh, d0.in_q, d0.mat, d0.mat_mma,
                      d0.horner_sh, T.q_ext), True),
        f"{tag} tail {alpha + 3}->{sm} chunk {ch}x{n2}": (
            T.in_q_tail, (T.one_tail, T.one_tail_sh, T.in_q_tail,
                          T.tail_mat, T.tail_mma, T.tail_hsh, T.q_main),
            False),
        f"{tag} moddown {alpha}+1->{sm} chunk {ch}x{n2}": (
            T.q_sp_full, (T.one_sp, T.one_sp_sh, T.q_sp_full, T.md_mat,
                          T.md_mma, T.md_hsh, T.q_main), True)}
    for label, (in_q, tabs, center) in cases.items():
        x = residues(in_q, (in_q.shape[0], ch, n2), rng)
        check_bconv(torch, label, x, tabs, center, results)
    label, (in_q, tabs, center) = next(iter(cases.items()))
    worst = (in_q - 1).view(-1, 1, 1).expand(-1, ch, n2).contiguous()
    check_bconv(torch, f"{label} worst case (x = q-1)", worst, tabs, center,
                results)
    H = build_limb_tables(dc, LEVEL_B, 2, 1, (1, 2))
    tag, w = "hybrid 2x2 rank(1,1)", n2 // 2
    d0, ch = H.digits[0], n1 // H.gchunks
    check_bconv(torch, f"{tag} modup digit0 {nd}+1->{H.sa + H.sm} chunk "
                f"{ch}x{w}", residues(d0.in_q, (nd, ch, w), rng),
                (d0.step1, d0.step1_sh, d0.in_q, d0.mat, d0.mat_mma,
                 d0.horner_sh, H.q_ext), True, results)
    for name in PHASE_KERNELS:
        nb, what, rep = ((H.ext_nt, "ext", beta) if name.startswith("ntt")
                         else (H.main_nt, "main", 1))
        x = phase_input(np, torch, name, nb, rep, False, rng)
        kernel = getattr(ntt_kernels, name)
        plain = getattr(ntt_mod, name + "_plain")
        compare(torch, name,
                f"{tag} c={w} {what} M={nb.q.shape[0]} rep={rep}",
                lambda: kernel(x, nb, rep), lambda: plain(x, nb, rep),
                phase_bound(nb, x.shape[0], x.shape[1], x.shape[2], name),
                results)


DATA_AXIS = "data B/d=2 "  # the label prefix of the batched shard shapes


def check_data_axis_kernels(np, torch, dc, rng, results):
    """Phase 3, the shapes a data-axis shard's batch of Bl = 2 elements
    gives the kernels at set B, level 35 (one launch over the batch): on
    coefficient rank 1 of 4 (c = 64), B8/B9 over the main rows at rep Bl
    (the ModUp iNTT), B6/B7 over a digit's other rows at rep Bl and over
    the tail's 34 output rows at rep 2 Bl, B8/B9 over the specials at rep
    2 Bl; on limb rank 1 of 4, B2 over its main rows at rep Bl, B3 of
    ModUp digit 0 onto its ext block on the digit's rows of a [Bl, 36, 64,
    256] gather chunk (a row slice: each element's rows contiguous, the
    elements a chunk apart), B1 over its ext block at rep beta Bl, B2 over
    its [specials, last-limb slot] at rep 2 Bl, B3 of the tail on a
    [Bl, 18, 64, 256] chunk, B1 over its main rows at rep 2 Bl; on hybrid
    rank (1, 1) of 2 x 2 (c = 128), B6/B7 over its ext block at rep beta
    Bl and B8/B9 over its main rows at rep Bl."""
    from homulator_tpu_torch.ops import ntt as ntt_mod
    from homulator_tpu_torch.ops import ntt_kernels
    from homulator_tpu_torch.parallel.limb_sharded import build_limb_tables

    bl = 2
    n1, n2 = dc.params.ntt.n1, dc.params.ntt.n2
    kt = dc.keyswitch_tables(LEVEL_B, shard=(1, NS))
    T = build_limb_tables(dc, LEVEL_B, 4, 1)
    H = build_limb_tables(dc, LEVEL_B, 2, 1, (1, 2))
    beta = len(T.digits)
    tag = f"coeff x{NS} rank1 c={n2 // NS}"
    phase = [(f"{tag} main", kt.main_nt, bl, ("intt_phase2", "intt_phase1")),
             (f"{tag} digit0 other", kt.digits[0].other_nt, bl,
              ("ntt_phase1", "ntt_phase2")),
             (f"{tag} tail out", kt.tail.out_nt, 2 * bl,
              ("ntt_phase1", "ntt_phase2")),
             (f"{tag} specials", kt.special_nt, 2 * bl,
              ("intt_phase2", "intt_phase1")),
             (f"hybrid 2x2 rank(1,1) c={n2 // 2} ext", H.ext_nt, beta * bl,
              ("ntt_phase1", "ntt_phase2")),
             (f"hybrid 2x2 rank(1,1) c={n2 // 2} main", H.main_nt, bl,
              ("intt_phase2", "intt_phase1"))]
    for what, nb, rep, names in phase:
        for name in names:
            x = phase_input(np, torch, name, nb, rep, False, rng)
            kernel = getattr(ntt_kernels, name)
            plain = getattr(ntt_mod, name + "_plain")
            compare(torch, name,
                    f"{DATA_AXIS}{what} M={nb.q.shape[0]} rep={rep}",
                    lambda: kernel(x, nb, rep), lambda: plain(x, nb, rep),
                    phase_bound(nb, x.shape[0], x.shape[1], x.shape[2],
                                name), results)
    tag = "limb x4 rank1"
    for name, nb, what, rep in (
            ("ntt_inv", T.main_nt, "main", bl),
            ("ntt_fwd", T.ext_nt, "ext", beta * bl),
            ("ntt_inv", T.tailzl_nt, "tailzl", 2 * bl),
            ("ntt_fwd", T.main_nt, "main", 2 * bl)):
        fwd = name == "ntt_fwd"
        q = np.tile(nb.q.cpu().numpy(), rep)
        x = residues(q, (len(q),) + ((n1, n2) if fwd else (n2, n1)), rng)
        kernel = ntt_kernels.ntt_fwd if fwd else ntt_kernels.ntt_inv
        plain = ntt_mod.ntt_plain if fwd else ntt_mod.intt_plain
        compare(torch, name,
                f"{DATA_AXIS}{tag} {what} M={nb.q.shape[0]} rep={rep}",
                lambda: kernel(x, nb, rep), lambda: plain(x, nb, rep),
                ntt_bound(nb, rep, fwd), results)
    ch, d0, sa = n1 // T.gchunks, T.digits[0], T.sa
    rows = 4 * T.sm  # the gathered main rows of the 4 shards
    q_rows = np.resize(np.asarray(dc.params.q_arr[:LEVEL_B], dtype=np.int64),
                       rows)
    gp = residues(np.tile(q_rows, bl), (bl * rows, ch, n2), rng).view(
        bl, rows, ch, n2)
    check_bconv(torch, f"{DATA_AXIS}{tag} modup digit0 {d0.hi - d0.lo}+1->"
                f"{sa + T.sm} on [{bl}, {rows}, {ch}, {n2}] chunk rows "
                f"{d0.lo}:{d0.hi}", gp[:, d0.lo:d0.hi],
                (d0.step1, d0.step1_sh, d0.in_q, d0.mat, d0.mat_mma,
                 d0.horner_sh, T.q_ext), True, results)
    nt = T.alpha + 3
    tail = residues(np.tile(T.in_q_tail.cpu().numpy(), bl), (bl * nt, ch, n2),
                    rng).view(bl, nt, ch, n2)
    check_bconv(torch, f"{DATA_AXIS}{tag} tail {nt}->{T.sm} on "
                f"[{bl}, {nt}, {ch}, {n2}]", tail,
                (T.one_tail, T.one_tail_sh, T.in_q_tail, T.tail_mat,
                 T.tail_mma, T.tail_hsh, T.q_main), False, results)


def check_data_batches(torch, kernels, eng, cts, labels, launches):
    """Phases 5 and 8, the data axis with two elements a shard (the
    shards' batch as one program): each of `labels`
    (scripts/bench_data_axis_torch.py's data_cases at set B, level 35, 2
    data rows: "coeff 2x4", "limb 2x4", "hybrid 2x(2x2)", "gspmd
    (2,2,2)") runs a batch of B = 2 (one element a shard) and of B = 4
    (two), each driven with the launch counts set to 0 just before and
    read just after (coeff, hybrid, gspmd: B3 and B6-B9 only; limb: B1-B3
    only). B = 4 equals four single-device hmults bit for bit, launches
    each kernel as often as B = 2 and makes as many collective calls on
    each axis, one element's (7 a shard on the coeff axis, one a
    transform; limb_collective_count on the limb axis, 4 on the hybrid's
    coeff axis), and each shard receives twice B = 2's bytes, which are
    one element's (ici_bytes_per_op, the limb and hybrid figures). Returns
    {run: (eager ms, profiled device ms)}."""
    from homulator_tpu_torch.parallel.limb_sharded import (
        limb_collective_count,
    )
    from homulator_tpu_torch.parallel.sharded import ici_bytes_per_op

    bench = _script("bench_data_axis_torch")
    params = eng.params
    a, b, want = bench.hmult_operands(torch, eng, cts)
    one = {  # one element's bytes and calls a shard, by label
        "coeff 2x4": (ici_bytes_per_op(params, LEVEL_B, NS, "hmult"),
                      {"coeff": 1 + params.beta(LEVEL_B) + 3}),
        "limb 2x4": (LIMB_BYTES[4][0], {"limb": limb_collective_count(
            params, LEVEL_B, 4)})}
    one["hybrid 2x(2x2)"] = one["gspmd (2,2,2)"] = (
        HYBRID_BYTES[(2, 2)][0],
        {"limb": limb_collective_count(params, LEVEL_B, 2, ns_c=2),
         "coeff": 4})
    timings = {}
    for label, (mesh, axes, make, join) in bench.data_cases(
            eng, LEVEL_B, labels).items():
        expect = (LIMB_KERNELS if label.startswith("limb") else
                  COEFF_KERNELS if label.startswith("coeff") else
                  HYBRID_KERNELS)
        seen = {}
        for B in (2, 4):
            run = f"hmult {label} data B={B}"
            fn = make(a[:B], b[:B])
            mesh.reset_counts()
            got, launches[run] = drive(torch, kernels, f"{run} (45,35,15)",
                                       fn, expect)
            if not torch.equal(join(got), want[:B]):
                raise AssertionError(f"{run}: != {B} single-device hmults")
            seen[B] = (launches[run], {name: mesh.calls(ax)
                                       for name, ax in axes},
                       mesh.recv_bytes)
            timings[run] = (latency_ms(fn), profiled_ms(fn)[0])
        per, calls = one[label]
        n = len(mesh.comms)
        if seen[2][1] != {k: [v] * n for k, v in calls.items()}:
            raise AssertionError(f"{label} B=2: collective calls {seen[2][1]}"
                                 f", one element's are {calls}")
        if seen[2][2] != [per] * n:
            raise AssertionError(f"{label} B=2: shards received "
                                 f"{seen[2][2]} bytes, one element's are "
                                 f"{per}")
        if seen[4][0] != seen[2][0]:
            raise AssertionError(f"{label}: B=4 launched {seen[4][0]}, B=2 "
                                 f"{seen[2][0]}: not one program a shard")
        if seen[4][1] != seen[2][1]:
            raise AssertionError(f"{label}: B=4 made {seen[4][1]} collective "
                                 f"calls, B=2 {seen[2][1]}")
        if seen[4][2] != [2 * per] * n:
            raise AssertionError(f"{label} B=4: shards received "
                                 f"{seen[4][2]} bytes, expected {2 * per}")
        print(f"# hmult {label} data B=4: == four single-device hmults, "
              f"bit-exact; two elements a shard as one program: launches "
              f"== B=2's ({sum(seen[2][0].values())}), collective calls a "
              "shard == B=2's ("
              + ", ".join(f"{k} {v}" for k, v in calls.items())
              + f"), {2 * per} bytes a shard == 2 x B=2's; eager / device "
              f"ms B=2 {timings[f'hmult {label} data B=2'][0]:.3f} / "
              f"{timings[f'hmult {label} data B=2'][1]:.3f}, B=4 "
              f"{timings[f'hmult {label} data B=4'][0]:.3f} / "
              f"{timings[f'hmult {label} data B=4'][1]:.3f} "
              "(torch.profiler; shards sharing one card)")
    return timings


def check_limb_dispatch(np, torch, kernels, eng, cts, wants, v12, launches,
                        errs):
    """Phase 5, the limb and hybrid dispatches at set B, level 35: limb
    hmult and hrotate(1) on ThreadMesh(2 | 4 | 8, names=("limb",)), hybrid
    on ThreadMesh((2 | 4, 2), names=("limb", "coeff")), its hrotate(1)
    on its route (an identity block map) and on the gather route, each run
    with the launch counts set to 0 just before and read just after (limb:
    B1, B2 and B3 only; hybrid: B3 and B6-B9 only); the gathered results equal
    the single-device piecewise ones (wants) on the real rows, the pad
    rows zero; the bytes each shard received, over all its axes, equal
    the JAX package's figures; the limb axis's collective calls equal
    limb_collective_count; the 4-shard limb and 2 x 2 hybrid hmults
    decrypt within GATE in every slot; then a batch of two hmults on 2
    data rows x 4 limb shards. Returns {label: (mesh, fn)} of the runs."""
    from homulator_tpu_torch.context import Ciphertext
    from homulator_tpu_torch.parallel import limb_sharded as ls
    from homulator_tpu_torch.parallel.comm import ThreadMesh

    params, dc = eng.params, eng.dc
    (ct1, ct2), (out, rot) = cts, wants
    g = params.galois_elt(1)
    perm = dc.automorph_perm(g)
    runs = {}  # label -> (mesh, fn, want, bytes, (ns_l, ns_c), kernels)
    for shape in [(ns, 1) for ns in NS_LIMB] + list(HYBRID_SHAPES):
        nl, nc = shape
        if nc == 1:
            mesh, tag = ThreadMesh(nl, "cuda", names=("limb",)), f"limb x{nl}"
            fh = ls.make_limb_hmult(dc, LEVEL_B, mesh)
            fr, route = ls.make_limb_hrotate(dc, LEVEL_B, mesh), perm
            nbytes, expect = LIMB_BYTES[nl], LIMB_KERNELS
            calc = (ls.ici_bytes_per_op_limb(params, LEVEL_B, nl, "hmult"),
                    ls.ici_bytes_per_op_limb(params, LEVEL_B, nl, "hrotate"))
        else:
            mesh = ThreadMesh(shape, "cuda", names=("limb", "coeff"))
            tag = f"hybrid {nl}x{nc}"
            fh = ls.make_hybrid_hmult(dc, LEVEL_B, mesh)
            fr = ls.make_hybrid_hrotate(dc, LEVEL_B, mesh)
            route = dc.automorph_shard_route(g, nc)
            nbytes, expect = HYBRID_BYTES[shape], HYBRID_KERNELS
            calc = tuple(ls.ici_bytes_per_op_hybrid(
                params, LEVEL_B, nl, nc, op, route_identity=ident)
                for op, ident in (("hmult", False), ("hrotate", route[2]),
                                  ("hrotate", False)))
        if calc != nbytes:
            raise AssertionError(f"{tag}: the port's byte counts {calc} != "
                                 f"the JAX package's {nbytes}")
        a, b = (ls.shard_rows(c.data, LEVEL_B, nl, nc) for c in (ct1, ct2))
        key = ls.limb_key(eng.relin_key, params, LEVEL_B, nl, nc)
        rk = ls.limb_key(eng.rot_keys[1], params, LEVEL_B, nl, nc)
        runs[f"hmult {tag}"] = (mesh, lambda f=fh, a=a, b=b, k=key: f(
            a, b, k), out.data, nbytes[0], shape, expect)
        runs[f"hrotate {tag}"] = (mesh, lambda f=fr, a=a, r=route, k=rk: f(
            a, r, k), rot.data, nbytes[1], shape, expect)
        if nc > 1:  # the automorphism's all_gather form in the coeff group
            runs[f"hrotate {tag} gather"] = (
                mesh, lambda f=fr, a=a, k=rk: f(a, (perm, None, False), k),
                rot.data, nbytes[2], shape, expect)
    for label, (mesh, fn, want, nbytes, (nl, nc), expect) in runs.items():
        mesh.reset_counts()
        got, launches[label] = drive(torch, kernels, f"{label} (45,35,15)",
                                     fn, expect)
        got = ls.gather_rows(got, nl, nc)
        rows = want.shape[1]
        if not torch.equal(got[:, :rows], want) or got[:, rows:].any():
            raise AssertionError(f"{label}: != single-device result on the "
                                 "real rows, or pad rows not zero")
        if mesh.recv_bytes != [nbytes] * len(mesh.comms):
            raise AssertionError(f"{label}: shards received "
                                 f"{mesh.recv_bytes} bytes, expected "
                                 f"{nbytes}")
        calls = ls.limb_collective_count(params, LEVEL_B, nl,
                                         label.split()[0], ns_c=nc)
        if mesh.calls("limb") != [calls] * len(mesh.comms):
            raise AssertionError(f"{label}: limb-axis collective calls "
                                 f"{mesh.calls('limb')}, "
                                 f"limb_collective_count = {calls}")
        print(f"# {label}: == single-device piecewise result, bit-exact, "
              f"pad rows zero; {nbytes} bytes received by each shard, "
              f"{calls} collective calls on the limb axis"
              + (f", {mesh.calls('coeff')[0]} on the coeff axis"
                 if nc > 1 else ""))
        if label in ("hmult limb x4", "hmult hybrid 2x2"):
            ct = Ciphertext(got[:, :rows].contiguous(), rows, out.scale)
            errs[label] = float(np.max(np.abs(eng.decrypt_complex(ct)
                                              - v12)))
            print(f"# verify max-abs-err = {errs[label]:.3e} ({label}), "
                  f"all {params.n // 2} slots")
            if not errs[label] < GATE:
                raise AssertionError(f"{label} decrypt gate {GATE} failed")
    # the batch axis: [ct1, ct2] x [ct2, ct1] on 2 data rows x 4 limb shards
    dmesh = ThreadMesh(4, "cuda", data=2, names=("limb",))
    batched = ls.make_limb_hmult(dc, LEVEL_B, dmesh, data_axis="data")
    ab = torch.stack([ct1.data, ct2.data])
    bb = torch.stack([ct2.data, ct1.data])
    key = ls.limb_key(eng.relin_key, params, LEVEL_B, 4)
    got, launches["hmult limb 2x4 data"] = drive(
        torch, kernels, "hmult limb 2x4 data (45,35,15)",
        lambda: batched(ls.shard_rows(ab, LEVEL_B, 4, data=2),
                        ls.shard_rows(bb, LEVEL_B, 4, data=2), key),
        LIMB_KERNELS)
    got = ls.gather_rows(got, 4, data=2)[:, :, :LEVEL_B - 1]
    want = torch.stack([out.data, eng.hmult(ct2, ct1).data])
    if not torch.equal(got, want):
        raise AssertionError("hmult on a 2 x 4 data x limb mesh != the "
                             "single-device hmults")
    print("# hmult limb 2x4 data: batch of 2 == single-device hmults, "
          "bit-exact")
    return {label: r[:2] for label, r in runs.items()}


def check_gspmd_surface(np, torch, kernels, eng, cts, pt, wants, launches,
                        errs, timings):
    """Phase 8, the JAX package's GSPMD surface on the port's explicit
    dispatches, the CLI's remainder, the counters and the dry run, at set
    B, level 35 (see the module docstring). Returns {op: counters}."""
    import contextlib
    import io

    from homulator_tpu_torch import cli
    from homulator_tpu_torch.api import (
        CkksEngine, get_params, hadd_graph, hsub_graph, padd_graph,
        pmult_graph,
    )
    from homulator_tpu_torch.context import Ciphertext, Plaintext
    from homulator_tpu_torch.dryrun import dryrun_multichip
    from homulator_tpu_torch.ops.ntt import intt_rep, ntt_rep
    from homulator_tpu_torch.parallel.coeff_ntt import make_coeff_sharded_ntt
    from homulator_tpu_torch.parallel.comm import ThreadMesh
    from homulator_tpu_torch.parallel.mesh import make_mesh
    from homulator_tpu_torch.parallel.sharded import (
        elementwise_axis, gather_cols, make_sharded_elementwise,
        make_sharded_hmult, shard_cols, shard_elementwise,
    )

    t_phase = time.perf_counter()
    params, dc = eng.params, eng.dc
    (ct1, ct2), (out, _) = cts, wants
    # make_sharded_hmult: [ct1, ct2] x [ct2, ct1] over (2, 2, 2) and (2, 4)
    ab = torch.stack([ct1.data, ct2.data])
    bb = torch.stack([ct2.data, ct1.data])
    want = torch.stack([out.data, eng.hmult(ct2, ct1).data])
    for shape, expect, per in (((2, 2, 2), HYBRID_KERNELS,
                                HYBRID_BYTES[(2, 2)][0]),
                               ((2, 4), LIMB_KERNELS, LIMB_BYTES[4][0])):
        mesh = make_mesh(shape, device="cuda")
        f = make_sharded_hmult(dc, LEVEL_B, mesh)
        label = f"make_sharded_hmult {shape}"
        mesh.reset_counts()
        got, launches[label] = drive(torch, kernels, f"{label} B=2 (45,35,15)",
                                     lambda: f(ab, bb, eng.relin_key), expect)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: != the single-device hmults")
        if mesh.recv_bytes != [per] * len(mesh.comms):
            raise AssertionError(f"{label}: shards received "
                                 f"{mesh.recv_bytes} bytes, expected {per}")
        print(f"# {label}: batch of 2 == single-device hmults, bit-exact; "
              f"{per} bytes received by each shard (one element a data "
              "row)")
        if shape == (2, 2, 2):
            fn = lambda f=f: f(ab, bb, eng.relin_key)  # noqa: E731
            timings[label] = (latency_ms(fn), profiled_ms(fn)[0])
            print(f"# {label} B=2 (45,35,15): {timings[label][0]:.3f} ms "
                  f"eager, {timings[label][1]:.3f} ms device "
                  "(torch.profiler); 8 shards sharing one card, not a "
                  "multi-card latency")
    # ... and on (2, 2, 2) with two elements a shard, B = 4 beside B = 2
    timings.update(check_data_batches(torch, kernels, eng, (ct1, ct2),
                                      ("gspmd (2,2,2)",), launches))
    # make_coeff_sharded_ntt on the 35 main rows: 4 shards (B6-B9), 8
    # shards (lane-packed, B10-B13)
    rows = dc.main_rows(LEVEL_B)
    nb = dc.ntt_basis(rows)
    x = residues(nb.q, (LEVEL_B, nb.n1, nb.n2), rng=11)
    ev = ntt_rep(x, nb, 1)
    if not torch.equal(intt_rep(ev, nb, 1), x):
        raise AssertionError("single-device ntt_rep / intt_rep round trip")
    for ns, expect in ((4, PHASE_KERNELS), (8, PACKED_KERNELS)):
        mesh = make_mesh((1, ns), device="cuda", axis_names=("data", "coeff"))
        f, fi = make_coeff_sharded_ntt(dc, rows, mesh)
        label = f"make_coeff_sharded_ntt x{ns}"
        (fwd, back), launches[label] = drive(
            torch, kernels, f"{label} (35 main rows)",
            lambda: (lambda y: (y, fi(y)))(f(shard_cols(x, ns))), expect)
        if not (torch.equal(gather_cols(fwd), ev)
                and torch.equal(gather_cols(back), x)):
            raise AssertionError(f"{label}: != single-device ntt_rep / "
                                 "intt_rep")
        print(f"# {label}: forward == ntt_rep, inverse == intt_rep, "
              "bit-exact")
    # the CLI at [cluster] 4, in-process, each with --verify
    for argv in (["hadd"], ["hsub"], ["padd"], ["pmult"], ["hsquare"],
                 ["hmult", "--dispatch", "gspmd"]):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["run", N16_CFG, argv[0], "45",
                           str(LEVEL_B), "15", "4", *argv[1:], "--verify",
                           "--iters", "3", "--device", "cuda"])
        text = buf.getvalue()
        keep = [ln for ln in text.splitlines()
                if ln.startswith(("# dispatch=", "# verify", "FHE-Op"))
                or "dispatch ==" in ln or ln.startswith("ICI_bytes")]
        print(f"# CLI {' '.join(argv)} 45 35 15 4 --verify "
              f"({time.perf_counter() - t0:.1f} s): " + " | ".join(keep))
        if rc != 0 or "bit-exact" not in text:
            raise AssertionError(f"CLI {argv} at cluster 4: rc {rc}\n{text}")
        if argv[0] in ("hadd", "hsub", "padd", "pmult") and not re.search(
                r"^ICI_bytes_per_device\s+0$", text, re.MULTILINE):
            raise AssertionError(f"CLI {argv[0]}: a shard received bytes")
        m = re.search(r"verify max-abs-err = (\S+)", text)
        errs[f"cli {argv[0]} x4"] = float(m.group(1))
    # the elementwise ops on 4 shards of this card in the CLI's layout (n2
    # at level 35), beside the single-device graph: eager and device ms
    axis = elementwise_axis(LEVEL_B, 4)
    mesh = ThreadMesh(4, "cuda")
    q = dc.q_level(LEVEL_B)
    for op, graph, other in (("hadd", hadd_graph, ct2.data),
                             ("hsub", hsub_graph, ct2.data),
                             ("padd", padd_graph, pt.data),
                             ("pmult", pmult_graph, pt.data)):
        f = make_sharded_elementwise(dc, op, LEVEL_B, mesh)
        a_s, b_s = (shard_elementwise(t, axis, 4) for t in (ct1.data, other))
        fn = lambda f=f, a=a_s, b=b_s: f(a, b)  # noqa: E731
        one = lambda g=graph, b=other: g(ct1.data, b, q)  # noqa: E731
        mesh.reset_counts()
        if not torch.equal(torch.cat(fn(), dim=axis), one()):
            raise AssertionError(f"{op} on 4 shards != single-device")
        if any(mesh.recv_bytes):
            raise AssertionError(f"{op} on 4 shards: a shard received bytes")
        label = f"{op} gspmd x4"
        timings[label] = (latency_ms(fn), profiled_ms(fn)[0])
        single = (latency_ms(one), device_ms(one))
        print(f"# {label} (45,35,15), n2 over 4 shards: == single-device, "
              f"bit-exact, 0 bytes a shard; {timings[label][0]:.3f} ms "
              f"eager, {timings[label][1]:.3f} ms device (torch.profiler; 4 "
              f"shards sharing one card); single device {single[0]:.3f} ms "
              f"eager, {single[1]:.3f} ms device (graph replay)")
    # op_cost_counters at set B, and the same counts on the CPU twin at
    # the oracle's N = 2^13
    ops = {"hmult": lambda e, a, b, p: e.hmult(a, b),
           "hsquare": lambda e, a, b, p: e.hsquare(a),
           "hrotate": lambda e, a, b, p: e.hrotate(a, 1),
           "hadd": lambda e, a, b, p: e.hadd(a, b),
           "hsub": lambda e, a, b, p: e.hsub(a, b),
           "padd": lambda e, a, b, p: e.padd(a, p),
           "pmult": lambda e, a, b, p: e.pmult(a, p)}
    counters = {}
    for op, fn in ops.items():
        cc = eng.op_cost_counters(op, ct1, ct2, pt)
        ms = latency_ms(lambda fn=fn: fn(eng, ct1, ct2, pt))
        cc["HBM_GBps_achieved"] = cc["HBM_bytes"] / ms / 1e6
        cc["eager_ms"] = ms
        counters[op] = cc
        print(f"# op_cost_counters {op}(45,35,15): " + ", ".join(
            f"{k} {v:.0f}" if k.endswith("bytes") else f"{k} {v:.3f}"
            for k, v in cc.items()) + " (HBM_bytes counted; GB/s over the "
            "eager median)")
    small = CkksEngine(get_params(n=1 << 13, max_level=8, alpha=3), seed=4,
                       device="cuda")
    small.keygen()
    small.gen_rotation_key(1)
    rng = np.random.default_rng(12)
    s1, s2 = (small.encrypt_complex(rng.normal(size=1 << 12), 8, SCALE)
              for _ in range(2))
    sp = small.plaintext_complex(rng.normal(size=1 << 12), 8, SCALE)
    twin = cpu_twin(small)
    c1, c2 = (Ciphertext(c.data.cpu(), c.level, c.scale) for c in (s1, s2))
    cp = Plaintext(sp.data.cpu(), sp.level, sp.scale)
    for op in ops:
        g = small.op_cost_counters(op, s1, s2, sp)
        c = twin.op_cost_counters(op, c1, c2, cp)
        if any(g[k] != c[k] for k in c):
            raise AssertionError(f"op_cost_counters {op} at N=2^13: card "
                                 f"{g} != CPU {c}")
    print("# op_cost_counters at N=2^13 L8 l8 a3, card == CPU plain path "
          "(HBM_bytes, MEM_arg_bytes, MEM_out_bytes), every op")
    # one --profile run of the CLI: its trace holds B1's launches
    prof_dir = os.path.join(ROOT, "build", "smoke_profile")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["run", N16_CFG, "hmult", "45", str(LEVEL_B),
                       "15", "--iters", "2", "--device", "cuda", "--profile",
                       prof_dir])
    text = buf.getvalue()
    with open(os.path.join(prof_dir, "homulator_tpu_torch_hmult.json")) as fh:
        trace = json.load(fh)
    b1 = sum(1 for e in trace["traceEvents"] if e.get("cat") == "kernel"
             and "ntt_fwd_radix" in e.get("name", ""))
    keep = [ln for ln in text.splitlines() if ln.startswith(
        ("FHE-Op", "HBM_", "MEM_", "# profiler"))]
    print("# CLI hmult 45 35 15 --profile: " + " | ".join(keep)
          + f"; {b1} B1 phase launches in the trace")
    if rc != 0 or b1 == 0:
        raise AssertionError(f"--profile run: rc {rc}, {b1} B1 launches in "
                             "its trace")
    # the dry run on a ThreadMesh of 8 shards on this card
    t0 = time.perf_counter()
    paths = dryrun_multichip(8, device="cuda")
    print(f"# dryrun_multichip(8, device='cuda'), ThreadMesh: {len(paths)} "
          f"paths bit-exact ({', '.join(paths)}) in "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"# phase 8 (GSPMD surface, CLI, counters, dry run): "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counters


def check_anatomy_kernels(np, torch, dc, rng, results):
    """Phase 3b, the NTT anatomy and roofline path (on no op's path): B14's
    variants, B15's forms and B16's parts on the M = 35 main limbs [256,
    256], the stage variants (B14's stages1 and stages2x, B15, B16's
    stages1) also in the worst case (every input q - 1), B17 on ModUp
    digit 0 (its 15 rows and a zero row -> 35 rows),
    each against its plain version bit for bit, with the one PyTorch call
    that computes the same function where there is one; each peak chain
    and the stream pass on the inputs the path gives them
    (benchlib.peak_inputs: 8 Mi residues, PEAK_ITERS iterations of 32
    links; two 256 MB arrays). Returns the path's inputs."""
    from homulator_tpu_torch.ops import anatomy, peaks
    from homulator_tpu_torch.ops.bconv_fused import (
        bconv_planes_mm, bconv_planes_mm_plain, byte_planes,
    )

    kt = dc.keyswitch_tables(LEVEL_B)
    nb = kt.main_nt
    M, n1, n2 = nb.q.shape[0], nb.n1, nb.n2
    x = residues(nb.q, (M, n1, n2), rng)
    copy_out = torch.empty_like(x)

    def transpose():
        return x.transpose(1, 2).contiguous()

    def bnd(spec):  # stage passes and mid product of a variant (B16's
        # copy, None: neither)
        return anatomy_bound(M, n1, n2, *(spec or (0, False))[:2])

    library = {"copy": lambda: copy_out.copy_(x), "transpose": transpose}
    worst = (nb.q - 1).view(-1, 1, 1).expand(-1, n1, n2).contiguous()
    for xf, tag in ((x, ""), (worst, " worst case (all q-1)")):
        for v, spec in anatomy.B14_VARIANTS.items():
            if not tag or spec and spec[0]:  # worst case: stage variants
                compare(torch, "ntt_anatomy", f"{v} M={M}{tag}",
                        lambda: anatomy.ntt_anatomy(xf, nb, v),
                        lambda: anatomy.ntt_anatomy_plain(xf, nb, v),
                        ntt_bound(nb, 1, True) if spec is None
                        else bnd(spec), results,
                        library=transpose if v == "copy" else None)
        for form, spec in anatomy.B15_FORMS.items():
            compare(torch, "ntt_shoup_forms", f"{form} M={M}{tag}",
                    lambda: anatomy.ntt_shoup_forms(xf, nb, form),
                    lambda: anatomy.ntt_shoup_forms_plain(xf, nb, form),
                    bnd(spec), results)
        for part, spec in anatomy.B16_PARTS.items():
            if not tag or spec and spec[0]:
                compare(torch, "ntt_components", f"{part} M={M}{tag}",
                        lambda: anatomy.ntt_components(xf, nb, part),
                        lambda: anatomy.ntt_components_plain(xf, nb, part),
                        bnd(spec), results, library=library.get(part))

    dt = kt.digits[0]
    nd, m_out = dt.hi - dt.lo, dt.other_nt.q.shape[0]
    mbig = dt.mat_bf16
    xd = residues(dt.in_q, (nd, n1, n2), rng)
    xdp = torch.cat([xd, torch.zeros_like(xd[:1])])
    planes = byte_planes(xdp).view(4 * (nd + 1), n1 * n2).to(torch.bfloat16)
    compare(torch, "bconv_planes_mm",
            f"modup digit0 {nd}+1->{m_out} ({4 * m_out} rows computed)",
            lambda: bconv_planes_mm(xdp, mbig),
            lambda: bconv_planes_mm_plain(xdp, mbig),
            planes_mm_bound(nd + 1, m_out, n1 * n2), results,
            library=lambda: torch.matmul(mbig, planes))

    x0, z, zx = peak_inputs()
    n, links = x0.numel(), PEAK_ITERS * peaks.S
    for op, link_ops in PEAK_LINK_OPS.items():
        # the plain chain is `links` rounds of int64 torch ops over x0
        compare(torch, "peak_" + op, f"n={n} iters={PEAK_ITERS} "
                f"({links} links)",
                lambda: peaks.chain(x0, PEAK_ITERS, op),
                lambda: peaks.chain_plain(x0, PEAK_ITERS, op),
                bound(8 * n, n * links * link_ops), results, calls=1,
                replays=3)
    big = z.numel()
    compare(torch, "peak_stream", f"n={big} (two 256 MB arrays)",
            lambda: peaks.stream(z, zx), lambda: peaks.stream_plain(z, zx),
            bound(12 * big, 2 * big), results, calls=2, replays=5)
    return nb, x, xdp, mbig, (x0, z, zx)


def check_oracle(np, torch, CkksEngine, get_params, api):
    """Phase 4: the port on the card vs RefCkks at N = 2^13, L8, a3, and
    a 16 x 16 linalg.bsgs_matvec on the graph route there; returns the
    matvec's decrypt error."""
    from homulator_tpu_torch import linalg
    from homulator_tpu_torch.context import Ciphertext

    pm = get_params(n=1 << 13, max_level=8, alpha=3)
    em = CkksEngine(pm, seed=3, device="cuda")
    em.keygen()
    rng = np.random.default_rng(4)
    half = pm.n // 2
    a = em.encrypt_complex(rng.normal(size=half), 8, SCALE)
    b = em.encrypt_complex(rng.normal(size=half), 8, SCALE)
    ref = em.ref.hmult(em.to_ref(a), em.to_ref(b))
    if not np.array_equal(ref.data, em.dc.download(em.hmult(a, b).data)):
        raise AssertionError("hmult(8,8,3) at N=2^13 != RefCkks.hmult")
    ref_sq = em.ref.hmult(em.to_ref(a), em.to_ref(a))
    if not np.array_equal(ref_sq.data, em.dc.download(em.hsquare(a).data)):
        raise AssertionError("hsquare(8,8,3) at N=2^13 != RefCkks.hmult(a, a)")
    for step in (1, -1):
        got = em.dc.download(em.hrotate(a, step).data)
        if not np.array_equal(em.ref.hrotate(em.to_ref(a), step).data, got):
            raise AssertionError(f"hrotate({step}) at N=2^13 != RefCkks.hrotate")
    api.USE_FUSED_HPIP = True
    try:
        fused = {"hmult": (em.hmult(a, b), ref),
                 "hsquare": (em.hsquare(a), ref_sq),
                 "hrotate(1)": (em.hrotate(a, 1),
                                em.ref.hrotate(em.to_ref(a), 1))}
    finally:
        api.USE_FUSED_HPIP = False
    for op, (got, want) in fused.items():
        if not np.array_equal(want.data, em.dc.download(got.data)):
            raise AssertionError(f"fused-route {op} at N=2^13 != RefCkks")
    conj = em.conjugate(a)
    cpu = CkksEngine(pm, seed=3, device="cpu")
    cpu.ref = em.ref
    cpu._conj_keys = {g: k.cpu() for g, k in em._conj_keys.items()}
    cpu.relin_key = em.relin_key.cpu()
    conj_cpu = cpu.conjugate(Ciphertext(a.data.cpu(), a.level, a.scale))
    if not torch.equal(conj.data.cpu(), conj_cpu.data):
        raise AssertionError("conjugate at N=2^13: GPU != CPU plain path")
    eg = CkksEngine(pm, seed=3, device="cuda", ntt_mode="jnp")
    eg.relin_key, eg.rot_keys = em.relin_key, em.rot_keys
    if not np.array_equal(ref.data, eg.dc.download(eg.hmult(a, b).data)):
        raise AssertionError("graph-route hmult at N=2^13 != RefCkks.hmult")
    for step in (1, -1):
        got = eg.dc.download(eg.hrotate(a, step).data)
        if not np.array_equal(em.ref.hrotate(em.to_ref(a), step).data, got):
            raise AssertionError(f"graph-route hrotate({step}) at N=2^13 != "
                                 "RefCkks.hrotate")
    print("# oracle N=2^13 L8 l8 a3: hmult, hsquare, hrotate(1), hrotate(-1) "
          "and fused-route hmult, hsquare, hrotate(1) == RefCkks; "
          "graph-route (ntt_mode='jnp') "
          "hmult, hrotate(1), hrotate(-1) == RefCkks; conjugate == CPU plain "
          "path; bit-exact")
    # encrypted linear algebra on the graph route: a 16 x 16 BSGS matvec
    # (baby steps 1-3 hoisted, giant steps 4, 8, 12)
    eg.ref = em.ref
    d = 16
    M, xv = rng.normal(size=(d, d)) / d, rng.normal(size=d)
    mv = linalg.bsgs_matvec(eg, linalg.encrypt_vector(eg, xv, 8, SCALE), M)
    err = float(np.max(np.abs(eg.decrypt_complex(mv).real[:d] - M @ xv)))
    print(f"# linalg.bsgs_matvec 16x16 at N=2^13 L8 l8 a3, graph route: "
          f"verify max-abs-err {err:.3e} against M @ x")
    if not err < GATE:
        raise AssertionError(f"bsgs_matvec decrypt gate {GATE} failed")
    return err


def check_native(np, get_params):
    """Phase 2: the native host core's keys, encodes and ciphertexts at
    N = 2^13 equal the numpy path's (RefCkks(use_native=False)) bit for
    bit; prints the seconds of each side."""
    from homulator_tpu_torch.refimpl import RefCkks

    pm = get_params(n=1 << 13, max_level=8, alpha=3)
    v = np.random.default_rng(8).normal(size=pm.n // 2)
    words, secs = {}, {}
    for label, use in (("numpy", False), ("native", True)):
        t0 = time.perf_counter()
        r = RefCkks(pm, seed=3, use_native=use)
        if use and r._native is None:
            raise AssertionError("RefCkks(use_native=True) took numpy")
        r.keygen()
        words[label] = (r.relin_key.digits + r.gen_rotation_key(1).digits
                        + [r.encrypt(r.encode_complex(v, 8, SCALE)).data])
        secs[label] = time.perf_counter() - t0
    if not all(np.array_equal(x, y)
               for x, y in zip(words["numpy"], words["native"])):
        raise AssertionError("native host core != numpy path at N=2^13")
    print(f"# native host core == numpy path at N=2^13 L8 a3 (relin key, "
          f"rotation key 1, encode + encrypt), bit-exact: "
          f"{secs['native']:.2f} s against {secs['numpy']:.2f} s")


def workload_cases(np, eng, level, scale, seed, d, g, cts=None):
    """Phase 7's inputs on one engine, from numpy's generator at `seed`: a
    d x d matrix and a d-vector for the matvec, a slot vector, weights and
    bias for logreg, the two vectors encrypted at (level, scale) (or the
    ciphertext tensors `cts`, moved to the engine's device). Returns
    (matvec prep, logreg prep, cases, prep seconds, ciphertext tensors):
    cases maps each workload to (its device function, the slots its
    decrypt should give, the output level and scale)."""
    from homulator_tpu_torch import workloads

    rng = np.random.default_rng(seed)
    slots = eng.params.n // 2
    M, x = rng.normal(size=(d, d)) / d, rng.normal(size=d)
    xs, w = rng.normal(size=slots), rng.normal(size=slots) / np.sqrt(slots)
    b = 0.3
    if cts is None:
        cts = [eng.encrypt_complex(v, level, scale).data
               for v in (np.tile(x, slots // d), xs)]
    ct_m, ct_l = (c.to(eng.dc.device) for c in cts)
    t0 = time.perf_counter()
    mprep = workloads.matvec_prep(eng, M, level, scale, g)
    t1 = time.perf_counter()
    lprep = workloads.logreg_prep(eng, w, b, level, scale)
    t2 = time.perf_counter()
    score = float(np.dot(xs, w) + b)
    c0, c1, c3 = workloads.SIGMOID3
    cases = {
        "matvec_bsgs": (lambda: workloads.matvec_bsgs(ct_m, mprep),
                        np.tile(M @ x, slots // d), level, mprep.out_scale),
        "logreg_sigmoid3": (
            lambda: workloads.logreg_sigmoid3(ct_l, lprep),
            np.full(slots, c0 + c1 * score + c3 * score**3),
            lprep.out_level, lprep.s_out),
    }
    return mprep, lprep, cases, (t1 - t0, t2 - t1), (ct_m, ct_l)


def check_workloads(np, torch, kernels, api, eng, get_params, launches):
    """Phase 7: the BSGS matvec (64 x 64, g = 8) and logreg at set B,
    level 35, on the engine of phase 5 (its host engine on the native
    core), which then holds the union of both workloads' rotation keys;
    each workload on the piecewise and the fused route with the launch
    counts around each run, the routes' outputs equal, full-slot decrypts
    within GATE, eager and device times; then both at N = 2^13 on the
    card against the CPU plain path. Returns (errors, timings)."""
    from homulator_tpu_torch import workloads
    from homulator_tpu_torch.context import Ciphertext
    from homulator_tpu_torch.refimpl import RefCkks

    t_phase = time.perf_counter()
    if eng.ref._native is None:
        raise AssertionError("phase 7: the engine's host engine is not on "
                             "the native core")
    params = eng.params
    slots = params.n // 2
    baby, giant = workloads.matvec_steps(64, 8)
    steps = sorted(set(baby + giant + workloads.logreg_steps(slots)))
    key_s = {}
    for s in steps:
        if s not in eng.rot_keys:
            t0 = time.perf_counter()
            eng.gen_rotation_key(s)
            key_s[s] = time.perf_counter() - t0
    key_bytes = sum(eng.rot_keys[s].numel() * 4 for s in steps)
    print(f"# set B rotation keys (host, native core, upload included), s "
          "each: " + ", ".join(f"{s}: {v:.2f}" for s, v in key_s.items())
          + f"; {len(steps)} keys, {key_bytes / 1e9:.2f} GB on the card")
    # one key and one encode on the numpy path, beside the native core
    ref_np = RefCkks(params, seed=1, use_native=False)
    ref_np.s_eval, ref_np.rot_keys = eng.ref.s_eval, {}
    v = np.random.default_rng(10).normal(size=slots)
    host = {}
    for label, ref in (("native", eng.ref), ("numpy", ref_np)):
        t0 = time.perf_counter()
        ref._gen_galois_key(params.galois_elt(3))
        t1 = time.perf_counter()
        pt = ref.encode_complex(v, LEVEL_B, SCALE)
        host[label] = (t1 - t0, time.perf_counter() - t1, pt.data)
    if not np.array_equal(host["native"][2], host["numpy"][2]):
        raise AssertionError("set B encode: native core != numpy path")
    print("# set B host engine alone, native core / numpy: rotation key "
          f"{host['native'][0]:.2f} / {host['numpy'][0]:.2f} s, "
          f"encode_complex at level {LEVEL_B} {host['native'][1]:.3f} / "
          f"{host['numpy'][1]:.3f} s (equal bits)")
    mprep, lprep, cases, prep_s, _ = workload_cases(
        np, eng, LEVEL_B, SCALE, 7, 64, 8)
    print(f"# set B workload prep (host, native core): matvec 64 diagonal "
          f"encodes {prep_s[0]:.2f} s ({prep_s[0] / 64:.3f} s each), logreg "
          f"weights, bias and constants {prep_s[1]:.2f} s")
    errs, timings, outs = {}, {}, {}
    for name, (fn, want, level, scale) in cases.items():
        # the matvec's hoisted baby rotations take B18 on either route
        hoisted = ("ip",) if name == "matvec_bsgs" else ()
        for fused in (False, True):
            label = name + (" fused" if fused else "")
            api.USE_FUSED_HPIP = fused
            try:
                outs[label], launches[label] = drive(
                    torch, kernels, f"{label} (45,35,15)", fn,
                    FUSED_KERNELS + hoisted if fused else PIECES_KERNELS)
                timings[label] = (latency_ms(fn), device_ms(fn, calls=2))
            finally:
                api.USE_FUSED_HPIP = False
            print(f"# {label}(45,35,15): {timings[label][0]:.3f} ms eager, "
                  f"{timings[label][1]:.3f} ms device time")
        ks = (mprep.keyswitches if name == "matvec_bsgs"
              else lprep.keyswitches)
        fused_ks = len(mprep.giant_keys) if name == "matvec_bsgs" else ks
        if launches[name + " fused"]["hpip"] != fused_ks:
            raise AssertionError(f"{name} fused: B4 launched "
                                 f"{launches[name + ' fused']['hpip']} "
                                 f"times, not {fused_ks}")
        ips = (launches[name]["ip"], launches[name + " fused"]["ip"])
        if ips != (ks, ks - fused_ks):
            raise AssertionError(f"{name}: B18 launched {ips} times "
                                 f"(piecewise, fused), not {ks}, "
                                 f"{ks - fused_ks}")
        if not torch.equal(outs[name], outs[name + " fused"]):
            raise AssertionError(f"{name}: fused route != piecewise route")
        got = eng.decrypt_complex(Ciphertext(outs[name], level, scale)).real
        errs[name] = float(np.max(np.abs(got - want)))
        print(f"# {name}(45,35,15): fused == piecewise, bit-exact; {ks} key "
              f"switches, B18 launched {ks} times piecewise and "
              f"{ks - fused_ks} fused, B4 {fused_ks} times fused; verify "
              f"max-abs-err = {errs[name]:.3e}, all {slots} slots")
        if not errs[name] < GATE:
            raise AssertionError(f"{name} decrypt gate {GATE} failed")
    # N = 2^13: the card on both routes against the CPU plain path, which
    # holds the card engine's keys and takes its ciphertexts
    pm = get_params(n=1 << 13, max_level=8, alpha=3)
    es = workloads.native_engine(pm, seed=5, device="cuda")
    es.keygen()
    _, _, small, _, cts = workload_cases(np, es, 8, SCALE, 9, 16, 4)
    ec = cpu_twin(es)
    small_cpu = workload_cases(np, ec, 8, SCALE, 9, 16, 4, cts)[2]
    for name, (fn, want, level, scale) in small.items():
        cpu = small_cpu[name][0]()
        for fused in (False, True):
            api.USE_FUSED_HPIP = fused
            try:
                got = fn()
            finally:
                api.USE_FUSED_HPIP = False
            if not torch.equal(got.cpu(), cpu):
                raise AssertionError(f"{name} at N=2^13, fused={fused}: "
                                     "GPU != CPU plain path")
        err = float(np.max(np.abs(ec.decrypt_complex(
            Ciphertext(cpu, level, scale)).real - want)))
        errs[f"{name} N=2^13"] = err
        if not err < GATE:
            raise AssertionError(f"{name} at N=2^13: decrypt gate failed")
    print("# matvec_bsgs 16x16 g=4 and logreg_sigmoid3 at N=2^13 L8 l8 a3: "
          "GPU (piecewise and fused) == CPU plain path, bit-exact; verify "
          f"max-abs-err {errs['matvec_bsgs N=2^13']:.3e}, "
          f"{errs['logreg_sigmoid3 N=2^13']:.3e}")
    print(f"# phase 7 (workloads): {time.perf_counter() - t_phase:.1f} s")
    return errs, timings


# phase 9, the op studies: the reference's other parameter sets (maxLevel,
# alpha; scripts/sweep_torch.py's PARAM_SETS), each at its max level and
# at level 2
STUDY_SETS = {"A": dict(n=1 << 15, max_level=28, alpha=28),
              "C": dict(n=1 << 16, max_level=24, alpha=6),
              "D": dict(n=1 << 16, max_level=26, alpha=9),
              "M": dict(n=1 << 16, max_level=28, alpha=28)}
BATCHES = (1, 2, 4, 8)
# B1-B4, B18, B19-B21
BATCH_KERNELS = ("ntt_fwd", "ntt_inv", "bconv", "hpip", "ip", "moddown")
STUDY = "phase 9 "  # the label prefix of phase 9's kernel shapes


def _script(name):
    """scripts/<name>.py of this checkout as a module (the op-study
    scripts' helpers)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_set_ops(np, torch, kernels, eng, name, level, launches, errs):
    """Phase 9: hmult, hrotate(1), hadd, pmult and padd of eng's set at
    `level`, each driven with the launch counts around it (the piecewise
    route's B1-B3 for the key switches, no kernel for the others), equal
    bit for bit to the host engine RefCkks (native core) on the same
    ciphertexts, and within GATE of the expected values in every slot:
    the key switches through the exact CRT decrypt, the elementwise ops
    through RefCkks' 3-prime CRT decode (every limb is held by the
    equality above)."""
    ref = eng.ref
    rng = np.random.default_rng(level)
    v1, v2, v3 = (rng.uniform(-0.5, 0.5, size=eng.params.n // 2)
                  for _ in range(3))
    ct1, ct2 = (eng.encrypt_complex(v, level, SCALE) for v in (v1, v2))
    r1, r2 = eng.to_ref(ct1), eng.to_ref(ct2)
    rpt = ref.encode_complex(v3, level, SCALE)
    pt = eng.dc.upload_pt(rpt.data, level, rpt.scale)
    ops = {  # op -> (run, oracle, expected slots, kernels, exact decrypt)
        "hmult": (lambda: eng.hmult(ct1, ct2), lambda: ref.hmult(r1, r2),
                  v1 * v2, PIECES_KERNELS, True),
        "hrotate(1)": (lambda: eng.hrotate(ct1, 1),
                       lambda: ref.hrotate(r1, 1), np.roll(v1, -1),
                       PIECES_KERNELS, True),
        "hadd": (lambda: eng.hadd(ct1, ct2), lambda: ref.hadd(r1, r2),
                 v1 + v2, (), False),
        "pmult": (lambda: eng.pmult(ct1, pt), lambda: ref.pmult(r1, rpt),
                  v1 * v3, (), False),
        "padd": (lambda: eng.padd(ct1, pt), lambda: ref.padd(r1, rpt),
                 v1 + v3, (), False),
    }
    line = []
    for op, (run, oracle, want, expect, exact) in ops.items():
        label = f"set {name} {op} level {level}"
        got, launches[label] = drive(torch, kernels, label, run, expect)
        if not np.array_equal(eng.dc.download(got.data), oracle().data):
            raise AssertionError(f"{label}: != RefCkks")
        dec = (eng.decrypt_complex(got) if exact
               else ref.decrypt_complex_fast(eng.to_ref(got)))
        errs[label] = float(np.max(np.abs(dec - want)))
        if not errs[label] < GATE:
            raise AssertionError(f"{label}: decrypt gate {GATE} failed: "
                                 f"{errs[label]:.3e}")
        line.append(f"{op} {errs[label]:.3e}")
    p = eng.params
    print(f"# set {name} (N=2^{p.n.bit_length() - 1}, maxLevel "
          f"{p.max_level}, alpha {p.alpha}, dnum {p.beta(level)}) level "
          f"{level}: hmult, hrotate(1), hadd, pmult, padd == RefCkks, "
          f"bit-exact; verify max-abs-err " + ", ".join(line)
          + f", all {p.n // 2} slots")


def check_study_kernels(np, torch, dcs, rng, results):
    """Phase 9: B3 on set A's fused tail (nd = alpha + 3 = 31 rows in, the
    widest table, four k32 steps) and ModUp digit 0 (28 + 1 rows), B4 at
    set A's level 28 (dnum 1) and set C's level 24 (dnum 4), B18 at set
    C's level 24 on a batch of 8, each against its plain version, at
    random inputs and every input q - 1."""
    da, dc_c = dcs["A"], dcs["C"]
    ka = da.keyswitch_tables(28)
    n1, n2 = da.params.ntt.n1, da.params.ntt.n2
    cases = bconv_cases(ka, STUDY + "set A ")
    for label in (next(k for k in cases if "tail" in k), next(iter(cases))):
        in_q, tabs, center = cases[label]
        check_bconv(torch, label, residues(in_q, (in_q.shape[0], n1, n2),
                                           rng), tabs, center, results)
        worst = (in_q - 1).view(-1, 1, 1).expand(-1, n1, n2).contiguous()
        check_bconv(torch, f"{label} worst case (x = q-1)", worst, tabs,
                    center, results)
    for label, dc, level in (("set A ", da, 28), ("set C ", dc_c, 24)):
        for worst in (False, True):
            check_hpip(np, torch, dc, level, worst, rng, results,
                       STUDY + label)
    # B18 at set C's level 24 (four 6-prime digits) on a batch of 8, as
    # the setC.hmult.b8 cell runs it, and in the worst case
    for worst in (False, True):
        check_ip(np, torch, dc_c, 24, worst, rng, results, STUDY + "set C ",
                 batch=8)
    # B19-B21 at set C's level 24 on a batch of 8 (the setC.hmult.b8
    # cell's ModDown + rescale), and in the worst case
    for worst in (False, True):
        check_moddown(np, torch, dc_c, 24, worst, rng, results,
                      STUDY + "set C ", batch=8)


def check_batch(np, torch, kernels, api, eng, rng, results, launches,
                timings):
    """Phase 9: the one-program batched hmult (batched_hmult_fn) at set B,
    level 35, B = 1, 2, 4, 8, on the piecewise and the fused route: each
    batch driven with the launch counts around it, equal bit for bit to B
    single engine.hmult calls, launching B1-B4 as often as one element
    does; eager and device ms at B = 1 and 8; then B1-B4 on a batch of 8
    against their plain versions on the card: B3 over a row slice of the
    batch (ModUp digit 1, elements 35 rows apart, as modup_convs_coeff
    passes it), B4 at level 35, B2 over the 8 elements' main rows and B1
    over the tail's 2 x 8 copies."""
    from homulator_tpu_torch.ops import ntt_kernels
    from homulator_tpu_torch.ops.ntt import intt_plain, ntt_plain
    from homulator_tpu_torch.parallel.sharded import batched_hmult_fn

    f = batched_hmult_fn(eng.dc, LEVEL_B)
    key = eng.relin_key
    cts = [eng.encrypt_complex(rng.uniform(-1, 1, size=eng.params.n // 2),
                               LEVEL_B, SCALE) for _ in range(4)]
    pairs = [(i, (i + j) % 4) for j in (1, 2) for i in range(4)]  # 8 pairs
    a = torch.stack([cts[i].data for i, _ in pairs])
    b = torch.stack([cts[j].data for _, j in pairs])
    for route, expect in (("piecewise", PIECES_KERNELS),
                          ("fused", FUSED_KERNELS)):
        api.USE_FUSED_HPIP = route == "fused"
        try:
            _, one = drive(torch, kernels, f"hmult one element {route}",
                           lambda: eng.hmult(cts[0], cts[1]), expect)
            singles = torch.stack([eng.hmult(cts[i], cts[j]).data
                                   for i, j in pairs])
            for B in BATCHES:
                label = f"hmult batch {B} {route}"
                got, launches[label] = drive(
                    torch, kernels, label, lambda: f(a[:B], b[:B], key),
                    expect)
                if not torch.equal(got, singles[:B]):
                    raise AssertionError(f"{label}: != {B} single hmults")
                if any(launches[label][k] != one[k] for k in BATCH_KERNELS):
                    raise AssertionError(f"{label}: launched B1-B4, B18 "
                                         f"{launches[label]}, one element "
                                         f"{one}")
                if B in (1, 8):
                    fn = (lambda bb=B: f(a[:bb], b[:bb], key))
                    timings[label] = (latency_ms(fn), device_ms(fn, calls=2))
                    print(f"# {label}: {timings[label][0]:.3f} ms eager, "
                          f"{timings[label][1]:.3f} ms device time a batch")
        finally:
            api.USE_FUSED_HPIP = False
    print(f"# batched hmult (45,35,15), B = {BATCHES}, piecewise and fused: "
          "== B single hmults, bit-exact; B1-B4 launched as for one element")
    kt = eng.dc.keyswitch_tables(LEVEL_B)
    n1, n2 = eng.params.ntt.n1, eng.params.ntt.n2
    quick = dict(calls=2, replays=5)
    dt = kt.digits[1]
    big = torch.stack([residues(kt.main_nt.q, (LEVEL_B, n1, n2), rng)
                       for _ in range(8)])
    x = big[:, dt.lo:dt.hi]
    tabs = (dt.step1, dt.step1_sh, dt.in_q, dt.mat, dt.mat_mma,
            dt.horner_sh, dt.other_nt.q)
    check_bconv(torch, f"{STUDY}batch 8 modup digit1 row slice "
                f"{dt.hi - dt.lo}+1->{dt.mat.shape[0]}", x, tabs, True,
                results, **quick)
    check_hpip(np, torch, eng.dc, LEVEL_B, False, rng, results,
               STUDY + "batch 8 ", 8, **quick)
    for name, kernel, plain, nb, rep, shape in (
            ("ntt_inv", ntt_kernels.ntt_inv, intt_plain, kt.main_nt, 8,
             (n2, n1)),
            ("ntt_fwd", ntt_kernels.ntt_fwd, ntt_plain, kt.tail.out_nt, 16,
             (n1, n2))):
        q = np.tile(nb.q.cpu().numpy(), rep)
        xn = residues(q, (len(q),) + shape, rng)
        compare(torch, name, f"{STUDY}batch 8 M={nb.q.shape[0]} rep={rep}",
                lambda: kernel(xn, nb, rep), lambda: plain(xn, nb, rep),
                ntt_bound(nb, rep, name == "ntt_fwd"), results, **quick)


def check_parity36(np, torch, kernels, get_params, launches, errs,
                   timings):
    """Phase 9: hmult at the 36-bit parity shape (scripts/
    bench_parity36_torch.parity36_shape, recomputed: (56, 43, 19) at N =
    2^16), driven with the launch counts around it, equal bit for bit to
    RefCkks and within GATE in every slot; its eager and device ms."""
    from homulator_tpu_torch.workloads import native_engine

    L, alpha, level, _ = _script("bench_parity36_torch").parity36_shape(
        1 << 16, 45, 15, 35)
    t0 = time.perf_counter()
    eng = native_engine(get_params(n=1 << 16, max_level=L, alpha=alpha),
                        seed=1)
    eng.keygen()
    key_s = time.perf_counter() - t0
    rng = np.random.default_rng(36)
    v1, v2 = (rng.uniform(-1, 1, size=eng.params.n // 2) for _ in range(2))
    ct1, ct2 = (eng.encrypt_complex(v, level, SCALE) for v in (v1, v2))
    label = f"hmult parity36 ({L},{level},{alpha})"
    out, launches[label] = drive(torch, kernels, label,
                                 lambda: eng.hmult(ct1, ct2), PIECES_KERNELS)
    if not np.array_equal(eng.dc.download(out.data), eng.ref.hmult(
            eng.to_ref(ct1), eng.to_ref(ct2)).data):
        raise AssertionError(f"{label}: != RefCkks")
    errs[label] = float(np.max(np.abs(eng.decrypt_complex(out) - v1 * v2)))
    if not errs[label] < GATE:
        raise AssertionError(f"{label}: decrypt gate {GATE} failed")
    timings[label] = (latency_ms(lambda: eng.hmult(ct1, ct2)),
                      device_ms(lambda: eng.hmult(ct1, ct2), calls=2))
    print(f"# {label}, dnum {eng.params.beta(level)}: == RefCkks, "
          f"bit-exact; verify max-abs-err {errs[label]:.3e}, all "
          f"{eng.params.n // 2} slots; {timings[label][0]:.3f} ms eager, "
          f"{timings[label][1]:.3f} ms device time; host keys and tables "
          f"{key_s:.1f} s")


def check_staged_automorph(np, torch, eng, rng, timings):
    """Phase 9: sigma_g of a rotation by one slot on [2 * 35, 256, 256]
    (set B's hrotate shape) three ways, bit-identical: the flat gather
    (automorph_eval), the staged form (automorph_eval_staged on
    DeviceContext.automorph_stage_maps) and the one-hot bf16 products of
    scripts/bench_automorph_torch.py; each one's device ms."""
    from homulator_tpu_torch.ops.automorph import (
        automorph_eval, automorph_eval_staged,
    )

    bench = _script("bench_automorph_torch")
    p = eng.params
    g = p.galois_elt(1)
    s1, s2, s3 = eng.dc.automorph_stage_maps(g)
    oh1, oh3 = bench.onehot_tables(s1, s3, p.ntt.n2)
    x = residues(np.full(2 * LEVEL_B, 1 << 30), (2 * LEVEL_B, p.ntt.n2,
                                                 p.ntt.n1), rng)
    forms = {"flat": lambda: automorph_eval(x, eng.dc.automorph_perm(g)),
             "staged": lambda: automorph_eval_staged(x, s1, s2, s3),
             "onehot": lambda: bench.onehot_auto(x, oh1, s2, oh3)}
    want = forms["flat"]()
    for form, fn in forms.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"automorphism {form} != flat")
        timings[f"automorph {form} [70, 256, 256]"] = (
            None, device_ms(fn))
    print("# automorphism on [70, 256, 256]: staged == one-hot == flat, "
          "bit-exact; device ms " + ", ".join(
              f"{form} {timings[f'automorph {form} [70, 256, 256]'][1]:.4f}"
              for form in forms))


def check_op_studies(np, torch, kernels, api, eng, get_params, results,
                     launches, errs, timings):
    """Phase 9, the op studies (see the module docstring): sets A, C, D
    and M through the engine, B3 and B4 at their widest shapes, the
    batched hmult, the 36-bit parity shape and the staged automorphism;
    eng is set B's engine (keys made, host engine on the native core)."""
    from homulator_tpu_torch.workloads import native_engine

    t_phase = time.perf_counter()
    rng = np.random.default_rng(19)
    dcs = {}
    for name, cfg in STUDY_SETS.items():
        t0 = time.perf_counter()
        e = native_engine(get_params(**cfg), seed=9)
        e.keygen()
        e.gen_rotation_key(1)
        print(f"# set {name}: params, relin and rotation key "
              f"{time.perf_counter() - t0:.1f} s (host, native core)")
        for level in (cfg["max_level"], 2):
            check_set_ops(np, torch, kernels, e, name, level, launches,
                          errs)
        if name in ("A", "C"):
            dcs[name] = e.dc
    check_study_kernels(np, torch, dcs, rng, results)
    check_batch(np, torch, kernels, api, eng, rng, results, launches,
                timings)
    check_parity36(np, torch, kernels, get_params, launches, errs, timings)
    check_staged_automorph(np, torch, eng, rng, timings)
    print(f"# phase 9 (op studies): {time.perf_counter() - t_phase:.1f} s")


# phase 10, the dispatch studies: shard 0's programs alone on the card
# (parallel.comm.StandInMesh), the kernels at the studies' shapes, and the
# dispatch model's anchors
STAND_INS = (("limb", 4, 1), ("coeff", 4, 1), ("coeff", 8, 1),
             ("hybrid", 2, 2))  # (axis, shards or limb shards, coeff shards)
DISPATCH = "phase 10 "  # the label prefix of phase 10's kernel shapes
GRID_MS = (4, 60)  # B1/B2 limb counts of the grid study checked here
WIDTH_NSS = (1, 2, 4, 8)  # the width study's shards: c = 256 / ns columns


def check_stand_ins(torch, kernels, eng, cts, thread_runs, timings,
                    launches):
    """Phase 10: limb x4, coeff x4, coeff x8 (lane-packed) and hybrid 2x2
    hmult and hrotate(1) as shard 0's program on a StandInMesh
    (parallel.comm.standin_programs), each driven with the launch counts
    around it (its dispatch's kernels only). Its
    output's shape, the bytes it counts and its calls on every axis equal
    those of the ThreadMesh's rank 0 in the same call (thread_runs: phase
    5's {label: (mesh, fn)}); the bytes also ici_bytes_per_op / the JAX
    figures, the limb axis's calls limb_collective_count. Then it is
    captured in a CUDA graph and its device ms printed beside the
    ThreadMesh's profiled device ms / ns (phase 6)."""
    from homulator_tpu_torch.parallel import limb_sharded as ls
    from homulator_tpu_torch.parallel.comm import standin_programs
    from homulator_tpu_torch.parallel.sharded import ici_bytes_per_op

    params = eng.params
    for axis, ns, nc in STAND_INS:
        mesh, fns = standin_programs(eng, LEVEL_B, axis, ns, nc, cts)
        tag = f"hybrid {ns}x{nc}" if axis == "hybrid" else f"{axis} x{ns}"
        if axis == "coeff":
            ident = eng.dc.automorph_shard_route(params.galois_elt(1), ns)[2]
            want_bytes = (ici_bytes_per_op(params, LEVEL_B, ns, "hmult"),
                          ici_bytes_per_op(params, LEVEL_B, ns, "hrotate",
                                           route_identity=ident))
            expect = (COEFF_PACKED_KERNELS if ns in NS_PACKED
                      else COEFF_KERNELS)
        elif axis == "limb":
            want_bytes, expect = LIMB_BYTES[ns], LIMB_KERNELS
        else:
            want_bytes, expect = HYBRID_BYTES[(ns, nc)][:2], HYBRID_KERNELS
        for op, nbytes in zip(("hmult", "hrotate"), want_bytes):
            label = f"stand-in {op} {tag}"
            tmesh, tfn = thread_runs[f"{op} {tag}"]
            tmesh.reset_counts()
            want_shape = tuple(tfn()[0].shape)
            torch.cuda.synchronize()
            axes = tmesh.names or (None,)
            tcalls = {a: tmesh.calls(a)[0] for a in axes}
            mesh.reset_counts()
            got, launches[label] = drive(torch, kernels,
                                         f"{label} (45,35,15)", fns[op],
                                         expect)
            calls = {a: mesh.calls(a)[0] for a in axes}
            if tuple(got[0].shape) != want_shape:
                raise AssertionError(f"{label}: shape {tuple(got[0].shape)}"
                                     f" != ThreadMesh rank 0's {want_shape}")
            if mesh.recv_bytes != [nbytes] or tmesh.recv_bytes[0] != nbytes:
                raise AssertionError(f"{label}: {mesh.recv_bytes} bytes, "
                                     f"ThreadMesh rank 0 "
                                     f"{tmesh.recv_bytes[0]}, expected "
                                     f"{nbytes}")
            if calls != tcalls or ("limb" in calls and calls["limb"] !=
                                   ls.limb_collective_count(
                                       params, LEVEL_B, ns, op, ns_c=nc)):
                raise AssertionError(f"{label}: calls {calls}, ThreadMesh "
                                     f"rank 0 {tcalls}")
            dev = device_ms(fns[op], calls=2)
            thread_dev = timings[f"{op} {tag}"][1]
            timings[label] = (None, dev)
            print(f"# {label} (45,35,15), shard 0 alone: shape "
                  f"{want_shape}, {nbytes} bytes, calls {calls}, each == "
                  f"ThreadMesh rank 0's; CUDA graph {dev:.4f} ms device; "
                  f"ThreadMesh {thread_dev:.4f} ms device (profiled) / "
                  f"{ns * nc} = {thread_dev / (ns * nc):.4f}")


def check_study_shapes(np, torch, dc, rng, results):
    """Phase 10: the kernels at the grid and width studies' shapes against
    their plain versions, bit for bit, with bounds: B6 and B7 at one shard
    (c = 256, the 35 main rows), B10 and B11 at k = 2 (4 shards, c = 64,
    the basis packed as the context packs it; no dispatch takes k = 2),
    B1 and B2 at M = 4 and 60 limbs (scripts/bench_ntt_grid_torch.py's
    rows) and B3 of ModUp digit 0 on [15, n1, c] at c = 256, 128, 64, 32
    (scripts/bench_ntt_width_torch.py)."""
    import dataclasses

    from homulator_tpu_torch.ops import ntt as ntt_mod
    from homulator_tpu_torch.ops import ntt_kernels

    rows = dc.main_rows(LEVEL_B)
    n1, n2 = dc.params.ntt.n1, dc.params.ntt.n2
    one = dc.ntt_basis(rows, (0, 1))
    k2 = dataclasses.replace(dc.ntt_basis(rows, (0, 4)), pack=2)
    for name, nb, tag in (
            ("ntt_phase1", one, "ns=1 c=256"), ("ntt_phase2", one,
                                                "ns=1 c=256"),
            ("ntt_phase1_packed", k2, "ns=4 c=64 k=2"),
            ("ntt_phase2_packed", k2, "ns=4 c=64 k=2")):
        x = phase_input(np, torch, name, nb, 1, False, rng)
        kernel = getattr(ntt_kernels, name)
        plain = getattr(ntt_mod, name + "_plain")
        c = x.shape[2] // (nb.pack or 1)
        compare(torch, name, f"{DISPATCH}{tag} main M=35 rep=1",
                lambda: kernel(x, nb, 1), lambda: plain(x, nb, 1),
                phase_bound(nb, x.shape[0] * (nb.pack or 1), x.shape[1], c,
                            name), results)
    grid = _script("bench_ntt_grid_torch")
    for M in GRID_MS:
        nb = dc.ntt_basis(grid.grid_rows(M))
        for name, kernel, plain, shape in (
                ("ntt_fwd", ntt_kernels.ntt_fwd, ntt_mod.ntt_plain, (n1, n2)),
                ("ntt_inv", ntt_kernels.ntt_inv, ntt_mod.intt_plain,
                 (n2, n1))):
            x = residues(nb.q, (M,) + shape, rng)
            compare(torch, name, f"{DISPATCH}grid M={M} rep=1",
                    lambda: kernel(x, nb, 1), lambda: plain(x, nb, 1),
                    ntt_bound(nb, 1, name == "ntt_fwd"), results)
    dt = dc.keyswitch_tables(LEVEL_B).digits[0]
    tabs = (dt.step1, dt.step1_sh, dt.in_q, dt.mat, dt.mat_mma,
            dt.horner_sh, dt.other_nt.q)
    for ns in WIDTH_NSS:
        c = n2 // ns
        check_bconv(torch, f"{DISPATCH}width modup digit0 {dt.hi - dt.lo}+1"
                    f"->{dt.mat.shape[0]} c={c}",
                    residues(dt.in_q, (dt.hi - dt.lo, n1, c), rng), tabs,
                    True, results)


def check_anchors(params):
    """Phase 10: the committed anchors (parallel/_scaling_measured.py) load,
    were measured at set B, and route set B's hmult and hrotate at 2, 4
    and 8 shards by the model (choose_axis's how == "model"); prints the
    picks and the anchors' card beside this one."""
    from homulator_tpu_torch.parallel import dispatch_model as dm

    if dm.MEASURED is None:
        raise AssertionError("parallel/_scaling_measured.py did not load")
    meta = dm.MEASURED["meta"]
    if meta["params"] != SET_B:
        raise AssertionError(f"anchors measured at {meta['params']}, not "
                             f"set B {SET_B}")
    picks = []
    for op in ("hmult", "hrotate"):
        for ns in (2, 4, 8):
            axis, t_l, t_c, how = dm.choose_axis(params, op, ns, LEVEL_B)
            if how != "model":
                raise AssertionError(f"choose_axis {op} x{ns} at set B: "
                                     f"how {how!r}, not 'model'")
            picks.append(f"{op} x{ns} {axis} (limb {t_l:.3f} / coeff "
                         f"{t_c:.3f} ms)")
    print("# dispatch model at set B, level 35 (H100 SXM5 fabric spec, not "
          "measured): " + "; ".join(picks))
    print(f"# anchors measured on {meta['card']} ({meta['measured_at']}); "
          f"this card: {benchlib.card_line()}")


def check_dispatch_studies(np, torch, kernels, eng, cts, thread_runs,
                           results, launches, timings):
    """Phase 10, the dispatch studies (see the module docstring)."""
    t_phase = time.perf_counter()
    check_stand_ins(torch, kernels, eng, cts, thread_runs, timings,
                    launches)
    check_study_shapes(np, torch, eng.dc, np.random.default_rng(20),
                       results)
    check_anchors(eng.params)
    print(f"# phase 10 (dispatch studies): "
          f"{time.perf_counter() - t_phase:.1f} s")


def op_studies_main() -> int:
    """Phase 9 alone, for a quick run on a card (python3 -c 'import
    chip_smoke; chip_smoke.op_studies_main()'): the kernel build, the
    native core, set B's engine and keys, then check_op_studies; its
    kernel shapes, launches and times as one JSON line."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from homulator_tpu_torch import api, kernels, native
    from homulator_tpu_torch.api import get_params
    from homulator_tpu_torch.workloads import native_engine

    t0 = time.perf_counter()
    print(benchlib.card_line())
    kernels.build()
    kernels.load()
    native.build()
    native.load()
    eng = native_engine(get_params(**SET_B), seed=1)
    eng.keygen()
    results = {k: [] for k in KERNELS}
    launches, errs, timings = {}, {}, {}
    check_op_studies(np, torch, kernels, api, eng, get_params, results,
                     launches, errs, timings)
    print(json.dumps({"kernels": {k: v for k, v in results.items() if v},
                      "launches": launches, "verify_max_err": errs,
                      "timings": timings}))
    print(f"# op studies alone: {time.perf_counter() - t0:.1f} s")
    return 0


def cpu_twin(eng):
    """The CPU plain-path engine of eng's params holding eng's host engine
    and keys."""
    from homulator_tpu_torch.api import CkksEngine

    cpu = CkksEngine(eng.params, device="cpu")
    cpu.ref = eng.ref
    cpu.relin_key = eng.relin_key.cpu()
    cpu.rot_keys = {s: k.cpu() for s, k in eng.rot_keys.items()}
    return cpu


def drive(torch, kernels, name, fn, expect):
    """One main-path run: launch counts set to 0 just before, read just
    after; every kernel in `expect` must have launched, and no other."""
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    print(f"# {name} kernel launches: {counts}")
    missing = [k for k in expect if counts[k] == 0]
    extra = [k for k, v in counts.items() if v and k not in expect]
    if missing or extra:
        raise AssertionError(f"{name}: kernels not launched {missing}, "
                             f"launched off their route {extra}")
    return out, counts


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from homulator_tpu_torch import api, kernels, native
    from homulator_tpu_torch.api import CkksEngine, get_params
    from homulator_tpu_torch.ops import anatomy, peaks
    from homulator_tpu_torch.ops.bconv_fused import bconv_planes_mm
    from homulator_tpu_torch.context import Ciphertext, Plaintext
    from homulator_tpu_torch.parallel.comm import ThreadMesh
    from homulator_tpu_torch.parallel.sharded import (
        gather_batch, gather_cols, ici_bytes_per_op, make_shardmap_hmult,
        make_shardmap_hrotate, shard_batch, shard_cols,
    )

    # 1. the card
    print(benchlib.card_line())
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. kernel build
    t0 = time.perf_counter()
    nvcc_s = kernels.build()
    kernels.load()
    print(f"# kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {nvcc_s:.1f} s) -> {os.path.relpath(kernels.library_path(), ROOT)}")
    with open(kernels.library_path()[:-3] + ".log") as f:
        log_text = f.read()
    for line in log_text.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("#   " + line.strip())
    regs = kernel_registers(log_text)
    for name, by_arg in sorted(regs.items()):
        arg = ("KS" if name in ("bconv_kernel", "bconv_step2_kernel",
                                "planes_mm")
               else "L, form, runs, store" if name == "stages_radix"
               else "digits" if name == "ip_kernel"
               else "L")
        print(f"# {name} ptxas, {arg}: registers / local bytes: "
              + ", ".join(f"{a}: {r} / {sp}" for a, (r, sp)
                          in sorted(by_arg.items())))
    if {k: len(v) for k, v in regs.items()} != CHECKED_INSTANTIATIONS:
        raise AssertionError("nvcc's log lacks B1-B17 "
                             f"instantiations: {regs}")
    spilled = {f"{name}<{a}>": sp for name, by_arg in regs.items()
               for a, (_, sp) in by_arg.items() if sp}
    if spilled:
        raise AssertionError("B1-B17 instantiations "
                             f"use local memory (stack or spill bytes): "
                             f"{spilled}")
    # ... and the native host core (g++), which every engine below takes
    t0 = time.perf_counter()
    gxx = subprocess.run([native.CXX, "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    gxx_s = native.build()
    native.load()
    print(f"# native host core build: {time.perf_counter() - t0:.1f} s "
          f"(g++ {gxx_s:.1f} s; {gxx}; {' '.join(native.CXXFLAGS)}) -> "
          f"{os.path.relpath(native.library_path(), ROOT)}")
    check_native(np, get_params)

    # 3. kernels vs plain versions at the set-B shapes
    t0 = time.perf_counter()
    params = get_params(**SET_B)
    print(f"# set B params: {time.perf_counter() - t0:.1f} s")
    eng = CkksEngine(params, seed=1, device="cuda")
    results = {k: [] for k in KERNELS}
    t0 = time.perf_counter()
    check_kernels(np, torch, eng.dc, np.random.default_rng(2), results,
                  get_params)
    check_radix_sweep(np, torch, get_params)
    check_phase_kernels(np, torch, eng.dc, np.random.default_rng(3), results)
    check_limb_kernels(np, torch, eng.dc, np.random.default_rng(4), results)
    check_data_axis_kernels(np, torch, eng.dc, np.random.default_rng(5),
                            results)
    check_step2_kernel(np, torch, eng.dc, np.random.default_rng(6), results)
    print(f"# kernel checks: {time.perf_counter() - t0:.1f} s")

    # 3b. the NTT anatomy and roofline path: its kernels vs their plain
    # versions, then the path driven once with the launch counts around it
    t0 = time.perf_counter()
    nb_a, x_a, xdp, mbig, (x0, z, zx) = check_anatomy_kernels(
        np, torch, eng.dc, np.random.default_rng(9), results)

    def anatomy_path():
        """What the anatomy and roofline scripts run, each kernel called
        eagerly, so each count is a kernel the card ran: the peak chains
        and the stream at the roofline's sizes, every anatomy variant, and
        B17 (the scripts time the same calls by CUDA-graph replay)."""
        for op in PEAK_LINK_OPS:
            peaks.chain(x0, PEAK_ITERS, op)
        peaks.stream(z, zx)
        for v in anatomy.B14_VARIANTS:
            anatomy.ntt_anatomy(x_a, nb_a, v)
        for form in anatomy.B15_FORMS:
            anatomy.ntt_shoup_forms(x_a, nb_a, form)
        for part in anatomy.B16_PARTS:
            anatomy.ntt_components(x_a, nb_a, part)
        bconv_planes_mm(xdp, mbig)

    launches = {}
    _, launches["anatomy and roofline path"] = drive(
        torch, kernels, "anatomy and roofline path", anatomy_path,
        ANATOMY_KERNELS + ("ntt_fwd",))
    peak_rates = benchlib.peak_rates(iters=PEAK_ITERS, replays=3)
    print("# peaks, one short sample each (CUDA-graph replay): "
          + ", ".join(f"{k} {v:.4g}" for k, v in peak_rates.items()))
    print(f"# anatomy checks and path: {time.perf_counter() - t0:.1f} s")

    # 4. independent oracle at a mid size with a partial digit
    err_matvec = check_oracle(np, torch, CkksEngine, get_params, api)

    # 5. set B through the engine
    for what, fn in (("relin key", eng.keygen),
                     ("rotation key step 1", lambda: eng.gen_rotation_key(1)),
                     ("rotation key step 2", lambda: eng.gen_rotation_key(2))):
        t0 = time.perf_counter()
        fn()
        print(f"# set B {what} (host, native core): "
              f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(7)
    slots = params.n // 2
    v1, v2 = rng.normal(size=slots), rng.normal(size=slots)
    t0 = time.perf_counter()
    ct1 = eng.encrypt_complex(v1, LEVEL_B, SCALE)
    ct2 = eng.encrypt_complex(v2, LEVEL_B, SCALE)
    print(f"# set B encrypt (host, native core): "
          f"{time.perf_counter() - t0:.1f} s")
    out, launches["hmult"] = drive(torch, kernels, "hmult(45,35,15)",
                                   lambda: eng.hmult(ct1, ct2), PIECES_KERNELS)
    rot, launches["hrotate"] = drive(torch, kernels, "hrotate(45,35,15)",
                                     lambda: eng.hrotate(ct1, 1),
                                     PIECES_KERNELS)
    api.USE_FUSED_HPIP = True
    try:
        out_f, launches["hmult fused"] = drive(
            torch, kernels, "hmult(45,35,15) fused", lambda: eng.hmult(ct1, ct2),
            FUSED_KERNELS)
        rot_f, launches["hrotate fused"] = drive(
            torch, kernels, "hrotate(45,35,15) fused",
            lambda: eng.hrotate(ct1, 1), FUSED_KERNELS)
        sq_f, launches["hsquare fused"] = drive(
            torch, kernels, "hsquare(45,35,15) fused",
            lambda: eng.hsquare(ct1), FUSED_KERNELS)
    finally:
        api.USE_FUSED_HPIP = False
    for label, c in (("hmult", launches["hmult fused"]),
                     ("hrotate", launches["hrotate fused"]),
                     ("hsquare", launches["hsquare fused"])):
        if c["hpip"] != 1:
            raise AssertionError(f"fused {label}: B4 launched {c['hpip']} "
                                 "times, not once")
    for label in ("hmult", "hrotate"):
        if launches[label]["ip"] != 1:
            raise AssertionError(f"{label}: B18 launched "
                                 f"{launches[label]['ip']} times, not once")
    if not (torch.equal(out.data, out_f.data)
            and torch.equal(rot.data, rot_f.data)
            and torch.equal(eng.hsquare(ct1).data, sq_f.data)):
        raise AssertionError("fused HPIP route != piecewise route")
    print("# fused HPIP route == piecewise route (hmult, hrotate, hsquare), "
          "bit-exact; B4 launched once an op fused, B18 once piecewise")

    cpu = cpu_twin(eng)  # the plain path
    cts_cpu = [Ciphertext(c.data.cpu(), c.level, c.scale) for c in (ct1, ct2)]
    t0 = time.perf_counter()
    out_cpu = cpu.hmult(*cts_cpu)
    rot_cpu = cpu.hrotate(cts_cpu[0], 1)
    print(f"# plain path (CPU) hmult + hrotate: {time.perf_counter() - t0:.1f} s")
    if not torch.equal(out.data.cpu(), out_cpu.data):
        raise AssertionError("hmult(45,35,15): GPU != CPU plain path")
    if not torch.equal(rot.data.cpu(), rot_cpu.data):
        raise AssertionError("hrotate(45,35,15): GPU != CPU plain path")
    errs = {}
    err_mult = float(np.max(np.abs(eng.decrypt_complex(out) - v1 * v2)))
    sq = eng.hsquare(ct1)
    err_sq = float(np.max(np.abs(eng.decrypt_complex(sq) - v1 * v1)))
    err_rot = float(np.max(np.abs(eng.decrypt_complex(rot)
                                  - np.roll(v1, -1))))
    print(f"# verify max-abs-err = {err_mult:.3e} (hmult), {err_sq:.3e} "
          f"(hsquare), {err_rot:.3e} (hrotate), all {slots} slots")
    if not (err_mult < GATE and err_sq < GATE and err_rot < GATE):
        raise AssertionError(f"decrypt gate {GATE} failed")
    hoisted, launches["hrotate_hoisted [1, 2]"] = drive(
        torch, kernels, "hrotate_hoisted(45,35,15) [1, 2]",
        lambda: eng.hrotate_hoisted(ct1, [1, 2]), PIECES_KERNELS)
    if launches["hrotate_hoisted [1, 2]"]["ip"] != 2:
        raise AssertionError("hrotate_hoisted [1, 2]: B18 launched "
                             f"{launches['hrotate_hoisted [1, 2]']['ip']} "
                             "times, not once a rotation")
    if not (torch.equal(hoisted[0].data, rot.data) and torch.equal(
            hoisted[1].data, eng.hrotate(ct1, 2).data)):
        raise AssertionError("hrotate_hoisted(ct, [1, 2]) != two hrotates")
    print("# hrotate_hoisted(ct, [1, 2]) == hrotate(ct, 1), hrotate(ct, 2), "
          "bit-exact")

    # 5, the graph route: a second engine (ntt_mode="jnp") holding the
    # first one's host engine and uploaded keys
    geng = CkksEngine(params, seed=1, device="cuda", ntt_mode="jnp")
    geng.ref, geng.relin_key = eng.ref, eng.relin_key
    geng.rot_keys = dict(eng.rot_keys)
    conj = eng.conjugate(ct1)  # makes the conjugation key
    geng._conj_keys = dict(eng._conj_keys)
    rkey = eng.rot_keys[1]
    graph_runs = {  # label -> (fn, accelerated result, kernels)
        "hmult graph": (lambda: geng.hmult(ct1, ct2).data, out.data,
                        GRAPH_KERNELS),
        "hsquare graph": (lambda: geng.hsquare(ct1).data, sq.data,
                          GRAPH_KERNELS),
        "hrotate graph": (lambda: geng.hrotate(ct1, 1).data, rot.data,
                          GRAPH_KERNELS),
        "conjugate graph": (lambda: geng.conjugate(ct1).data, conj.data,
                            GRAPH_KERNELS),
        "hrotate_hoisted graph": (
            lambda: torch.stack([c.data for c in
                                 geng.hrotate_hoisted(ct1, [1, 2])]),
            torch.stack([h.data for h in hoisted]), GRAPH_KERNELS),
        "keyswitch_poly graph": (
            lambda: geng.keyswitch_poly(ct1.data[1], rkey, LEVEL_B),
            eng.keyswitch_poly(ct1.data[1], rkey, LEVEL_B), GRAPH_KERNELS),
        # rescale has no base conversion on either route
        "rescale graph": (lambda: geng.rescale(ct1).data,
                          eng.rescale(ct1).data, RESCALE_KERNELS),
    }
    for label, (fn, want, expect) in graph_runs.items():
        got, launches[label] = drive(torch, kernels, f"{label} (45,35,15)",
                                     fn, expect)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: != the accelerated route")
    print("# graph route (ntt_mode='jnp') == accelerated route: hmult, "
          "hsquare, hrotate(1), conjugate, hrotate_hoisted([1, 2]), "
          "keyswitch_poly, rescale; bit-exact")
    # the elementwise surface vs the CPU plain path, full-slot decrypts
    pt2 = geng.plaintext_complex(v2, LEVEL_B, SCALE)
    pt_cpu = Plaintext(pt2.data.cpu(), pt2.level, pt2.scale)
    elem = {  # label -> (op on (engine, a, b, pt), expected slots)
        "hadd": (lambda e, a, b, p: e.hadd(a, b), v1 + v2),
        "hsub": (lambda e, a, b, p: e.hsub(a, b), v1 - v2),
        "padd": (lambda e, a, b, p: e.padd(a, p), v1 + v2),
        "pmult": (lambda e, a, b, p: e.pmult(a, p), v1 * v2),
        "cmult": (lambda e, a, b, p: e.cmult(a, 0.5), 0.5 * v1),
        "cadd": (lambda e, a, b, p: e.cadd(a, 0.25), v1 + 0.25),
        "rescale": (lambda e, a, b, p: e.rescale(e.pmult(a, p)), v1 * v2),
        "mod_drop": (lambda e, a, b, p: e.mod_drop(a), v1),
    }
    for label, (f, expected) in elem.items():
        got = f(geng, ct1, ct2, pt2)
        if not torch.equal(got.data.cpu(), f(cpu, *cts_cpu, pt_cpu).data):
            raise AssertionError(f"{label}(45,35,15): GPU != CPU plain path")
        errs[label] = float(np.max(np.abs(geng.decrypt_complex(got)
                                          - expected)))
        if not errs[label] < GATE:
            raise AssertionError(f"{label} decrypt gate {GATE} failed: "
                                 f"{errs[label]:.3e}")
    print("# hadd, hsub, padd, pmult, cmult(0.5), cadd(0.25), rescale(pmult), "
          "mod_drop == CPU plain path, bit-exact; verify max-abs-err "
          + ", ".join(f"{errs[k]:.3e} ({k})" for k in elem)
          + f", all {slots} slots")

    # 5, sharded: the coefficient dispatch on 4, 8, 16 and 32 shards of
    # this one card, at the JAX package's default routing
    sharded = {}  # label -> (fn, single-device result, bytes, kernels)
    for ns in (NS,) + NS_PACKED:
        mesh = ThreadMesh(ns, "cuda")
        sh_mult = make_shardmap_hmult(eng.dc, LEVEL_B, mesh)
        sh_rot = make_shardmap_hrotate(eng.dc, LEVEL_B, mesh)
        route = eng.dc.automorph_shard_route(params.galois_elt(1), ns)
        a_s, b_s = shard_cols(ct1.data, ns), shard_cols(ct2.data, ns)
        key_s, rkey_s = shard_cols(eng.relin_key, ns), shard_cols(rkey, ns)
        ici = (ici_bytes_per_op(params, LEVEL_B, ns, "hmult"),
               ici_bytes_per_op(params, LEVEL_B, ns, "hrotate",
                                route_identity=route[2]))
        if ns in PACKED_BYTES and ici != PACKED_BYTES[ns]:
            raise AssertionError(f"ici_bytes_per_op at {ns} shards gives "
                                 f"{ici}, the JAX package {PACKED_BYTES[ns]}")
        expect = COEFF_PACKED_KERNELS if ns in NS_PACKED else COEFF_KERNELS
        sharded[f"hmult coeff x{ns}"] = (
            mesh, lambda f=sh_mult, a=a_s, b=b_s, k=key_s: f(a, b, k),
            out.data, ici[0], expect)
        sharded[f"hrotate coeff x{ns}"] = (
            mesh, lambda f=sh_rot, a=a_s, r=route, k=rkey_s: f(a, r, k),
            rot.data, ici[1], expect)
    for label, (mesh, fn, want, ici, expect) in sharded.items():
        mesh.reset_counts()
        got, launches[label] = drive(torch, kernels, f"{label} (45,35,15)",
                                     fn, expect)
        got = gather_cols(got)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: != single-device result")
        if mesh.recv_bytes != [ici] * mesh.size:
            raise AssertionError(f"{label}: shards received "
                                 f"{mesh.recv_bytes} bytes, "
                                 f"ici_bytes_per_op = {ici}")
        print(f"# {label}: == single-device piecewise result, bit-exact; "
              f"{ici} bytes received by each shard == ici_bytes_per_op")
        if label in ("hmult coeff x4", "hmult coeff x8"):
            errs[label] = float(np.max(np.abs(eng.decrypt_complex(Ciphertext(
                got, LEVEL_B - 1, out.scale)) - v1 * v2)))
            print(f"# verify max-abs-err = {errs[label]:.3e} ({label}), all "
                  f"{slots} slots")
            if not errs[label] < GATE:
                raise AssertionError(f"{label} decrypt gate {GATE} failed")
    # the batch axis: [ct1, ct2] x [ct2, ct1] on 2 data rows x 4 shards
    dmesh = ThreadMesh(NS, "cuda", data=2)
    batched = make_shardmap_hmult(eng.dc, LEVEL_B, dmesh, data_axis="data")
    ab = torch.stack([ct1.data, ct2.data])
    bb = torch.stack([ct2.data, ct1.data])
    got, launches["hmult coeff 2x4 data"] = drive(
        torch, kernels, "hmult coeff 2x4 data (45,35,15)",
        lambda: batched(shard_batch(ab, 2, NS), shard_batch(bb, 2, NS),
                        shard_cols(eng.relin_key, NS)), COEFF_KERNELS)
    want = torch.stack([out.data, eng.hmult(ct2, ct1).data])
    if not torch.equal(gather_batch(got, 2), want):
        raise AssertionError("hmult on a 2 x 4 data x coeff mesh != the "
                             "single-device hmults")
    print("# hmult coeff 2x4 data: batch of 2 == single-device hmults, "
          "bit-exact")
    # 5, limb and hybrid: the limb dispatch on 2, 4 and 8 shards of this
    # card and on 2 data rows x 4, the hybrid on 2 x 2 and 4 x 2
    t0 = time.perf_counter()
    thread_runs = check_limb_dispatch(np, torch, kernels, eng, (ct1, ct2),
                                      (out, rot), v1 * v2, launches, errs)
    thread_runs.update((k, v[:2]) for k, v in sharded.items())
    print(f"# limb and hybrid dispatch checks: "
          f"{time.perf_counter() - t0:.1f} s (tables built included)")
    # 5, the data axis with two elements a shard: coeff 2 x 4, limb 2 x 4,
    # hybrid 2 x (2 x 2), B = 4 beside B = 2
    t0 = time.perf_counter()
    data_timings = check_data_batches(
        torch, kernels, eng, (ct1, ct2),
        ("coeff 2x4", "limb 2x4", "hybrid 2x(2x2)"), launches)
    print(f"# data-axis batch checks: {time.perf_counter() - t0:.1f} s")

    # 6. timings
    torch.cuda.reset_peak_memory_stats()
    timed = {  # label -> (fn, fused route?)
        "hmult": (lambda: eng.hmult(ct1, ct2), False),
        "hsquare": (lambda: eng.hsquare(ct1), False),
        "hrotate": (lambda: eng.hrotate(ct1, 1), False),
        "hmult fused": (lambda: eng.hmult(ct1, ct2), True),
        "hrotate fused": (lambda: eng.hrotate(ct1, 1), True),
        "hmult graph": (lambda: geng.hmult(ct1, ct2), False),
        "hrotate graph": (lambda: geng.hrotate(ct1, 1), False),
    }
    timings = dict(data_timings)
    for label, (fn, fused) in timed.items():
        api.USE_FUSED_HPIP = fused
        try:
            timings[label] = (latency_ms(fn), device_ms(fn, calls=2))
        finally:
            api.USE_FUSED_HPIP = False
        print(f"# {label}(45,35,15): {timings[label][0]:.3f} ms eager, "
              f"{timings[label][1]:.3f} ms device time")
    for label, eager_ms in (
            ("hadd", lambda: benchlib.hadd_ms(geng, ct1, ct2, eager=True)),
            ("pmult", lambda: benchlib.pmult_ms(geng, ct1, pt2, eager=True)),
            ("padd", lambda: benchlib.padd_ms(geng, ct1, pt2, eager=True)),
            ("rescale", lambda: latency_ms(lambda: geng.rescale(ct1)))):
        timings[label] = (eager_ms(), None)
        print(f"# {label}(45,35,15): {timings[label][0]:.3f} ms eager")
    # the sharded dispatches beside each other at 2, 4 and 8 shards: eager
    # latency and device time (torch.profiler: no graph capture across the
    # shard threads); a ThreadMesh of shards on this one card each
    mesh2 = ThreadMesh(2, "cuda")
    c2 = (make_shardmap_hmult(eng.dc, LEVEL_B, mesh2),
          make_shardmap_hrotate(eng.dc, LEVEL_B, mesh2),
          eng.dc.automorph_shard_route(params.galois_elt(1), 2))
    a2 = shard_cols(ct1.data, 2)
    b2, k2, r2 = (shard_cols(t, 2) for t in (ct2.data, eng.relin_key, rkey))
    sharded_fns = {"hmult coeff x2": lambda: c2[0](a2, b2, k2),
                   "hrotate coeff x2": lambda: c2[1](a2, c2[2], r2)}
    for ns in (4, 8):
        for op in ("hmult", "hrotate"):
            sharded_fns[f"{op} coeff x{ns}"] = sharded[f"{op} coeff x{ns}"][1]
    sharded_fns.update((k, f) for k, (_, f) in thread_runs.items()
                       if k.split()[1] in ("limb", "hybrid")
                       and not k.endswith("gather"))
    t0 = time.perf_counter()
    for label, fn in sharded_fns.items():
        timings[label] = (latency_ms(fn), profiled_ms(fn)[0])
        print(f"# {label}(45,35,15): {timings[label][0]:.3f} ms eager, "
              f"{timings[label][1]:.3f} ms device (torch.profiler); a "
              "ThreadMesh of shards on one card, not a multi-card latency")
    print(f"# sharded timings: {time.perf_counter() - t0:.1f} s")
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"# (eager: CUDA events, median of 20 after 3 warm-up runs; device "
          f"time: CUDA graph replay; peak memory {peak:.0f} MiB)")

    # 7. the encrypted workloads at set B
    wl_errs, wl_timings = check_workloads(np, torch, kernels, api, eng,
                                          get_params, launches)
    errs.update(wl_errs)
    timings.update(wl_timings)

    # 8. the GSPMD surface, the CLI's remainder, the counters, the dry run
    counters = check_gspmd_surface(
        np, torch, kernels, eng, (ct1, ct2),
        eng.plaintext_complex(v2, LEVEL_B, SCALE), (out, rot), launches,
        errs, timings)

    # 9. the op studies
    check_op_studies(np, torch, kernels, api, eng, get_params, results,
                     launches, errs, timings)

    # 10. the dispatch studies
    check_dispatch_studies(np, torch, kernels, eng, (ct1, ct2), thread_runs,
                           results, launches, timings)

    # 11. results
    print(f"# chip_smoke total: {time.perf_counter() - t_start:.1f} s "
          "(kernel build included)")
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "homulator_tpu"))
    if bad:
        raise AssertionError(f"the port imported {bad}")
    # headline shape of each kernel: one that the main path launches
    headline = {"ntt_fwd": "tail out M=34 rep=2", "ntt_inv": "main M=35 rep=1",
                "bconv": results["bconv"][0][0],
                "hpip": results["hpip"][0][0],
                "bconv_step2": results["bconv_step2"][0][0]}
    headline.update({k: "ns=4 c=64 main M=35 rep=1" for k in PHASE_KERNELS})
    headline.update({k: "ns=8 c=32 k=4 main M=35 rep=1"
                     for k in PACKED_KERNELS})
    rows = []
    for name in KERNELS:
        res = results[name]
        ms, plain_ms, bound_ms, bound_by, library_ms = next(
            r[2:] for r in res if r[0] == headline.get(name, res[0][0]))
        row = {
            "name": name, "route": "cuda", "source": REPLACES[name][0],
            "replaces": REPLACES[name][1],
            "shape": headline.get(name, res[0][0]),
            "launches": sum(c[name] for c in launches.values()),
            "launches_by_run": {run: c[name] for run, c in launches.items()},
            "max_abs_err": max(r[1] for r in res), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        }
        dispatch_rows = {r[0]: dict(zip(
            ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms"), r[1:])) for r in res
            if r[0].startswith(("limb", "hybrid"))}
        if dispatch_rows:
            row["limb_hybrid_shapes"] = dispatch_rows
        study_rows = {r[0][len(STUDY):]: dict(zip(
            ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms"), r[1:])) for r in res if r[0].startswith(STUDY)}
        if study_rows:
            row["op_studies_shapes"] = study_rows
        data_rows = {r[0][len(DATA_AXIS):]: dict(zip(
            ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms"), r[1:])) for r in res
            if r[0].startswith(DATA_AXIS)}
        if data_rows:
            row["data_axis_shapes"] = data_rows
        studies = {r[0][len(DISPATCH):]: dict(zip(
            ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms"), r[1:])) for r in res if r[0].startswith(DISPATCH)}
        if studies:
            row["dispatch_studies_shapes"] = studies
        if name in ANATOMY_KERNELS:
            row["note"] = ("on no op's path: launched by the anatomy and "
                           "roofline path only")
            row["variants"] = {r[0]: dict(zip(
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"),
                r[2:])) for r in res}
        rows.append(row)
    print(json.dumps({
        "kernels": rows, "peaks_short_sample": peak_rates,
        "eager_ms": {k: v[0] for k, v in timings.items()},
        "device_ms": {k: v[1] for k, v in timings.items()
                      if v[1] is not None},
        "verify_max_err": dict({"hmult": err_mult, "hsquare": err_sq,
                                "hrotate": err_rot,
                                "bsgs_matvec N=2^13": err_matvec}, **errs),
        "op_cost_counters": counters}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
