#!/usr/bin/env python3
"""Roofline of the port on the card: its measured peaks, and what the
port's kernels and ops achieve against them at parameter set B.

    python3 scripts/roofline_torch.py [--reps N] [--only-hoisted]

The port's counterpart of scripts/roofline.py. Every time is device time
(CUDA-graph replay, homulator_tpu_torch/benchlib.py), sampled --reps times
(default 5); the JSON keeps the best sample as the value (least time,
highest rate) and the median and worst as `<key>_med` and `<key>_worst`.

  PEAKS (benchlib.peak_rates; csrc/peaks.cu)
    peak_u32_mul_per_s       uint32 squaring chain y = y*y + 12345
    peak_shoup_modmul_per_s  Shoup-product chain
    peak_mont_modmul_per_s   Montgomery-product chain
    peak_bf16_flop_per_s     torch.matmul, 4096^2 bf16, f32 accumulation
    hbm_stream_gb_per_s      z*2654435761 ^ x over two 256 MB arrays

  ACHIEVED, set B (45, 35, 15)
    ntt       one iNTT + NTT pair of 35 limbs (B2 + B1): us per limb
              transform, modmul/s (log2(N) * N/2 + N a transform), HBM GB/s
              (a limb read and written a transform), and the issue
              ceiling: N times the port's own count of int32 operations an
              element, the mean of B1's and B2's (benchlib.radix_ntt_ops:
              a Harvey butterfly 9, log2(N)/2 a transform, and 10 / 8 for
              the mid product and the reductions; 81 at N = 2^16), over the
              Shoup chain's measured rate times its 5 operations a product.
              The TPU's NTT_OPS_PER_ELEM = 186 counts VPU instructions of
              its Pallas kernel and is not used.
    bconv     B3 (csrc/bconv.cu: step 1, the byte-plane product on the
              tensor cores, u8 x u8 -> s32, and the epilogue) at ModUp
              digit 0 (15+1 -> 35 rows), and beside it B17
              (csrc/bconv_mma.cu: the product alone, on the same core) on
              the same digit; bconv_pct_of_int8_peak is B17's u8 tensor-core
              operations a second (all 4 * m_out rows) over the published
              dense int8 rate (benchlib.INT8_OPS_PER_S; no int8 peak is
              measured), bconv_b3_over_b17 the ratio of their times.
    hmult, hrotate   modmul/s from stats.op_modmul_count over device time
    automorph        the gather of both components (ops/automorph.py), its
                     share of hrotate
    hoisted          hrotate_hoisted over k = 1, 2, 4, 8 steps sharing one
                     ModUp: ms a rotation

Writes ROOFLINE_H100.json at the root of the checkout (ROOFLINE.json is
the TPU's and is never written), with the card's name and power limit;
--only-hoisted re-runs the hoisted section into that file. Fails if a
share of a peak reads above 105%. Imports no JAX and nothing of the JAX
package.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "ROOFLINE_H100.json")
LEVEL = 35
SCALE = float(1 << 29)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5,
                    help="samples per measured metric (best/med/worst)")
    ap.add_argument("--only-hoisted", action="store_true",
                    help="re-run only the hoisted section, merged into the "
                         "existing ROOFLINE_H100.json")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("roofline_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from homulator_tpu_torch import benchlib
    from homulator_tpu_torch.benchlib import OPS, radix_ntt_ops
    from homulator_tpu_torch.api import CkksEngine, get_params
    from homulator_tpu_torch.ops.automorph import automorph_eval
    from homulator_tpu_torch.ops.bconv_fused import (
        bconv_fused, bconv_planes_mm,
    )
    from homulator_tpu_torch.stats import op_modmul_count

    card = benchlib.card_line()
    print(card)
    if args.only_hoisted:
        with open(OUT) as f:
            results = json.load(f)
    else:
        results = {}
    results.update({"device": card, "torch": torch.__version__,
                    "cuda": torch.version.cuda})

    def sample(fn):
        """--reps samples of a time fn(): (least, median, most)."""
        vals = sorted(fn() for _ in range(args.reps))
        return vals[0], vals[len(vals) // 2], vals[-1]

    def put(name, vals):
        results[name], results[name + "_med"], results[name + "_worst"] = vals

    def flush():
        with open(OUT, "w") as f:
            json.dump(results, f, indent=1)

    params = get_params(n=1 << 16, max_level=45, alpha=15)
    n = params.n
    eng = CkksEngine(params, seed=1, device="cuda")
    eng.keygen()
    m = np.zeros(n, dtype=np.int64)
    m[0] = int(3 * SCALE)
    ct1 = eng.encrypt_ints(m, LEVEL, SCALE)
    ct2 = eng.encrypt_ints(m, LEVEL, SCALE)

    if not args.only_hoisted:
        # ---- peaks ---------------------------------------------------------
        peaks = [benchlib.peak_rates() for _ in range(args.reps)]
        for key in peaks[0]:
            vals = sorted((p[key] for p in peaks), reverse=True)
            put(key, (vals[0], vals[len(vals) // 2], vals[-1]))
        flush()

        # ---- NTT ------------------------------------------------------------
        logn = n.bit_length() - 1
        lo, med, hi = sample(
            lambda: benchlib.ntt_pair_ms(eng, ct1.data[0], LEVEL))
        put("ntt_us_per_limb_transform",
            tuple(1e3 * v / (2 * LEVEL) for v in (lo, med, hi)))
        per_tf = lo * 1e-3 / (2 * LEVEL)
        results["ntt_achieved_modmul_per_s"] = (logn * (n // 2) + n) / per_tf
        results["ntt_pct_of_shoup_peak"] = (
            100 * results["ntt_achieved_modmul_per_s"]
            / results["peak_shoup_modmul_per_s"])
        results["ntt_hbm_gb_per_s"] = 2 * n * 4 / per_tf / 1e9
        results["ntt_pct_of_hbm_peak"] = (
            100 * results["ntt_hbm_gb_per_s"] / results["hbm_stream_gb_per_s"])
        ops_per_elem = (radix_ntt_ops(1, n, True)
                        + radix_ntt_ops(1, n, False)) / (2 * n)
        ceiling_s = n * ops_per_elem / (OPS["shoup"]
                                        * results["peak_shoup_modmul_per_s"])
        results["ntt_ops_per_elem"] = ops_per_elem
        results["ntt_ops_per_elem_count"] = (
            "benchlib.radix_ntt_ops / OPS, the mean of B1 and B2: int32 "
            f"operations, a Harvey butterfly {OPS['lazy_butterfly']} (N/2 "
            f"log2 N), a lazy mid product {OPS['lazy_shoup']} and "
            "conditional subtracts (3 in B1, 2 in B2) "
            f"{OPS['csub']} each (N); the Shoup chain's link "
            f"{OPS['shoup']}. Not the TPU's 186 VPU instructions.")
        results["ntt_issue_ceiling_us"] = ceiling_s * 1e6
        results["ntt_pct_of_issue_ceiling"] = 100 * ceiling_s / per_tf
        flush()

        # ---- base conversion: B3 and B17 at ModUp digit 0 -----------------
        dt = eng.dc.keyswitch_tables(LEVEL).digits[0]
        nd = dt.hi - dt.lo
        m_out = dt.other_nt.q.shape[0]
        xd = ct1.data[0][:nd].transpose(1, 2).contiguous()  # [nd, n1, n2]
        lo, med, hi = sample(lambda: benchlib.device_ms(
            lambda: bconv_fused(xd, dt.step1, dt.step1_sh, dt.in_q, dt.mat,
                                dt.mat_mma, dt.horner_sh, dt.other_nt.q,
                                center=True)))
        put("bconv_us_per_digit", tuple(1e3 * v for v in (lo, med, hi)))
        results["bconv_modmul_equiv_per_s"] = m_out * nd * n / (lo * 1e-3)
        results["bconv_kernel"] = (
            "B3 (csrc/bconv.cu) and B17 (csrc/bconv_mma.cu, the product "
            "alone, all 4*m_out rows) share csrc/planes_mma.cuh: u8 x u8 -> "
            "s32 mma.sync on the tensor cores; bconv_pct_of_int8_peak is "
            "B17's over the published dense int8 rate")
        mbig = dt.mat_bf16
        xdp = torch.cat([xd, torch.zeros_like(xd[:1])])
        lo, med, hi = sample(lambda: benchlib.device_ms(
            lambda: bconv_planes_mm(xdp, mbig)))
        put("bconv_matmul_only_us", tuple(1e3 * v for v in (lo, med, hi)))
        tc_ops = 2 * (4 * m_out) * (4 * (nd + 1)) * n
        results["bconv_tc_ops_per_s"] = tc_ops / (lo * 1e-3)
        results["bconv_pct_of_int8_peak"] = (
            100 * results["bconv_tc_ops_per_s"] / benchlib.INT8_OPS_PER_S)
        results["bconv_b3_over_b17"] = (results["bconv_us_per_digit"]
                                        / results["bconv_matmul_only_us"])
        flush()

        # ---- whole ops -----------------------------------------------------
        beta = params.beta(LEVEL)
        for op, timer in (
                ("hmult", lambda **kw: benchlib.hmult_ms(eng, ct1, ct2, **kw)),
                ("hrotate", lambda **kw: benchlib.hrotate_ms(eng, ct1, 1,
                                                             **kw))):
            vals = sample(timer)
            put(f"{op}_ms", vals)
            results[f"{op}_eager_ms"] = timer(eager=True)
            total = op_modmul_count(op, n, LEVEL, params.alpha, beta)
            results[f"{op}_modmul_total"] = total
            results[f"{op}_achieved_modmul_per_s"] = total / (vals[0] * 1e-3)
            results[f"{op}_pct_of_shoup_peak"] = (
                100 * results[f"{op}_achieved_modmul_per_s"]
                / results["peak_shoup_modmul_per_s"])
        perm = eng.dc.automorph_perm(params.galois_elt(1))
        vals = sample(lambda: benchlib.device_ms(
            lambda: automorph_eval(ct1.data, perm)))
        put("automorph_both_components_ms", vals)
        results["automorph_share_of_hrotate_pct"] = (
            100 * vals[0] / results["hrotate_ms"])
        flush()

    # ---- hoisted rotations: k steps sharing one ModUp ----------------------
    for k in (1, 2, 4, 8):
        steps = list(range(1, k + 1))
        for s in steps:
            if s not in eng.rot_keys:
                eng.gen_rotation_key(s)
        vals = sample(lambda: benchlib.device_ms(
            lambda: eng.hrotate_hoisted(ct1, steps), calls=2))
        put(f"hoisted_k{k}_per_rot_ms", tuple(v / k for v in vals))
        flush()
    results["hoisted_amortization_k8_vs_k1"] = (
        results["hoisted_k1_per_rot_ms"] / results["hoisted_k8_per_rot_ms"])
    flush()

    for k, v in results.items():
        print(f"{k:40s} {v if isinstance(v, str) else f'{v:.6g}'}")
    over = {k: v for k, v in results.items()
            if "_pct_of_" in k and isinstance(v, float) and v > 105}
    if over:
        raise AssertionError(f"shares above 105% of their peak: {over}")
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "homulator_tpu"))
    if bad:
        raise AssertionError(f"imported {bad}")
    print(json.dumps({"roofline": os.path.relpath(OUT, ROOT)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
