#!/usr/bin/env python3
"""Device time of kernels B3 (bconv_fused), B5 (bconv_step2) and B17
(bconv_planes_mm) at the shapes a set-B key switch gives them, for one
checkout of the port.

    python3 scripts/bench_bconv_torch.py [--root DIR] [--out FILE]

Times the `homulator_tpu_torch` of DIR (default: this checkout; another
one, such as an earlier commit unpacked with `git archive`, builds its own
kernels under its own build/): B3 at the five conversions of a piecewise
hmult at level 35 (ModUp digits 0-2, ModDown, the fused tail) and at ModUp
digit 0 on a 4-shard column slice, B5 at the graph route's ModUp digits 0
and 2 and ModDown (the rows of torch's step 1 and the count row), B17 on
ModUp digit 0 (its 15 rows and a zero row); each against its plain
version bit for bit, then the device time of one call (CUDA-graph replay,
the median of 20 replays of 10 calls; benchlib.device_ms). The table
arguments follow DIR's wrappers: B3 takes the device layout and horner_sh
where its tables have `mat_mma`, the matrix's Shoup pair (`mat_sh`) in
earlier checkouts; B5 the device layout and horner_sh where its tables
have no `mat_sh`, the Shoup pair before. It prints no bound:
two checkouts' kernels may do different work, and chip_smoke.py prints
the bound of its own. Prints the card's name and power limit and one JSON
line, also written to FILE. To compare two commits, run both in one call
on one card, in turns: parent, change, change, parent. Imports no JAX and
nothing of the JAX package.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL, NS = 35, 4
SET_B = dict(n=1 << 16, max_level=45, alpha=15)


def conversions(kt):
    """label -> (input primes, step-1 pair, the wrapper's table arguments,
    output primes, center) of B3 at kt's level, in DIR's API."""
    new = hasattr(kt.digits[0], "mat_mma")

    def tabs(mat, shoup, mma, hsh):
        return (mat, mma, hsh) if new else (mat, shoup)

    out = {}
    for d, dt in enumerate(kt.digits):
        out[f"modup digit{d} {dt.hi - dt.lo}+1->{dt.mat.shape[0]}"] = (
            dt.in_q, (dt.step1, dt.step1_sh),
            tabs(dt.mat, getattr(dt, "mat_sh", None),
                 getattr(dt, "mat_mma", None), getattr(dt, "horner_sh", None)),
            dt.other_nt.q, True)
    tt = kt.tail
    out[f"tail {tt.in_q.shape[0]}->{tt.mat.shape[0]}"] = (
        tt.in_q, (tt.one, tt.one_sh),
        tabs(tt.mat, getattr(tt, "mat_sh", None), getattr(tt, "mma", None),
             getattr(tt, "horner_sh", None)), tt.out_nt.q, False)
    out[f"moddown {kt.md_s1.shape[0]}+1->{kt.md_mat.shape[0]}"] = (
        kt.special_nt.q, (kt.md_s1, kt.md_s1_sh),
        tabs(kt.md_mat, getattr(kt, "md_mat_sh", None),
             getattr(kt, "md_mma", None),
             getattr(kt, "md_horner_sh", None)), kt.main_nt.q, True)
    return out


def step2_tabs(t, mat, mma, hsh):
    """B5's table arguments in DIR's API: the matrix, its device layout and
    horner_sh; or, where the tables keep the matrix's Shoup pair, the
    pair."""
    if hasattr(t, mat + "_sh"):
        return getattr(t, mat), getattr(t, mat + "_sh")
    return getattr(t, mat), getattr(t, mma), getattr(t, hsh)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose homulator_tpu_torch is timed")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_bconv_torch: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from homulator_tpu_torch import benchlib
    from homulator_tpu_torch.api import get_params
    from homulator_tpu_torch.context import DeviceContext
    from homulator_tpu_torch.ops.bconv import (
        bconv_step1_centered, bconv_step2, bconv_step2_plain,
    )
    from homulator_tpu_torch.ops.bconv_fused import (
        bconv_fused, bconv_planes_mm, bconv_planes_mm_plain, bconv_plain,
        build_bf16_tables, byte_planes,
    )

    if not benchlib.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {benchlib.__file__}, not from {root}")
    card = benchlib.card_line()
    print(card)
    dc = DeviceContext(get_params(**SET_B), "cuda")
    n1, n2 = dc.params.ntt.n1, dc.params.ntt.n2
    kt = dc.keyswitch_tables(LEVEL)
    cases = {k: v + ((n1, n2),) for k, v in conversions(kt).items()}
    label, case = next(iter(conversions(
        dc.keyswitch_tables(LEVEL, shard=(1, NS))).items()))
    cases[f"ns={NS} c={n2 // NS} {label}"] = case + ((n1, n2 // NS),)
    out = {"card": card, "root": root, "kernels": {"bconv": {}}}
    rows = out["kernels"]["bconv"]
    for label, (in_q, (s, s_sh), tabs, out_q, center, shape) in cases.items():
        x = benchlib.residues(in_q, (in_q.shape[0],) + shape, len(rows))

        def b3():
            return bconv_fused(x, s, s_sh, in_q, *tabs, out_q, center=center)

        if not torch.equal(b3(), bconv_plain(x, s, s_sh, in_q, tabs[0], out_q,
                                             center)):
            raise AssertionError(f"bconv {label}: != its plain version")
        rows[label] = benchlib.device_ms(b3)
        print(f"# bconv {label}: {rows[label]:.4f} ms")
    out["kernels"]["bconv_step2"] = rows = {}
    step2 = {  # label -> (step-1 pair, input primes, DIR's table args,
        # matrix, out q)
        f"modup digit{d}": ((dt.step1, dt.step1_sh), dt.in_q,
                            step2_tabs(dt, "mat", "mat_mma", "horner_sh"),
                            dt.mat, dt.other_nt.q)
        for d, dt in ((0, kt.digits[0]), (2, kt.digits[2]))}
    step2["moddown"] = ((kt.md_s1, kt.md_s1_sh), kt.special_nt.q,
                        step2_tabs(kt, "md_mat", "md_mma", "md_horner_sh"),
                        kt.md_mat, kt.main_nt.q)
    for label, ((s, s_sh), in_q, tabs, mat, out_q) in step2.items():
        x = benchlib.residues(in_q, (in_q.shape[0], n1, n2), len(rows))
        xhat = bconv_step1_centered(x, s, s_sh, in_q).to(torch.int32)
        label = f"{label} {xhat.shape[0]}->{out_q.shape[0]}"

        def b5():
            return bconv_step2(xhat, *tabs, out_q)

        if not torch.equal(b5(), bconv_step2_plain(xhat, mat, out_q)):
            raise AssertionError(f"bconv_step2 {label}: != its plain version")
        rows[label] = benchlib.device_ms(b5)
        print(f"# bconv_step2 {label}: {rows[label]:.4f} ms")
    dt = kt.digits[0]
    nd, m_out = dt.hi - dt.lo, dt.other_nt.q.shape[0]
    mbig = build_bf16_tables(dt.mat.cpu().numpy(),
                             dt.other_nt.q.cpu().numpy())[0].cuda()
    x = benchlib.residues(dt.in_q, (nd, n1, n2), 9)
    xdp = torch.cat([x, torch.zeros_like(x[:1])])
    if not torch.equal(bconv_planes_mm(xdp, mbig),
                       bconv_planes_mm_plain(xdp, mbig)):
        raise AssertionError("bconv_planes_mm: != its plain version")
    label = f"modup digit0 {nd}+1->{m_out} ({4 * m_out} rows computed)"
    planes = byte_planes(xdp).view(4 * (nd + 1), n1 * n2).to(torch.bfloat16)
    out["kernels"]["bconv_planes_mm"] = {
        label: benchlib.device_ms(lambda: bconv_planes_mm(xdp, mbig)),
        "torch.matmul": benchlib.device_ms(lambda: torch.matmul(mbig,
                                                                 planes))}
    for k, v in out["kernels"]["bconv_planes_mm"].items():
        print(f"# bconv_planes_mm {k}: {v:.4f} ms")
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
