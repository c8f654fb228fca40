"""CLI: `python -m homulator_tpu_torch run <cfg> <op> <maxLevel> <level>
<alpha> [cluster] [--verify] [--device cuda|cpu] [--fused-hpip]
[--dispatch auto|limb|coeff|hybrid|gspmd]`.

The reference's positional contract, as in `homulator_tpu/cli.py`: its
five operations hmult, hadd, hrotate (by one step), pmult and padd, and
the JAX CLI's hsub and hsquare; pmult and padd take the plaintext of the
second operand's slots. An unknown op (with the JAX CLI's message) and a
usage error (`--dispatch limb|coeff|hybrid` without a [cluster] above 1,
a tile that `coeff_shard_ok` rejects) exit with status 1, as the JAX
CLI's `SystemExit` does. `--verify` decrypts every slot and prints the
JAX CLI's `# verify max-abs-err = ...` line against the same
expectations; an error above 1e-2 exits with 1. The key switches take the
accelerated route (the graph route is the engine's ntt_mode="jnp").
`--fused-hpip` (or the cfg key `fused_hpip = 1`) routes key switches
through the fused HPIP kernel (api.USE_FUSED_HPIP) for the run and
restores the flag afterwards.

A [cluster] positional above 1 selects a multi-device dispatch, as in the
JAX CLI. `--dispatch coeff` runs hmult or hrotate coefficient-sharded
(parallel/sharded.py) on a ThreadMesh of [cluster] shards on the chosen
device, where `coeff_shard_ok` allows it, routed as the JAX CLI routes it
(`make_shardmap_*`'s default: the lane-packed phase kernels where
`pack_k_for` > 0, e.g. 8 to 32 shards at N = 2^16); it checks the bytes
each shard received against `ici_bytes_per_op` of that routing, and with
`--verify` the result against the single-device op bit for bit. The other
dispatches (auto, the default, and limb, hybrid, gspmd), and the ops
other than hmult and hrotate at [cluster] > 1 (which the JAX CLI runs
through GSPMD), exit with status 2 and name ROADMAP A12.

The stat table has the JAX CLI's keys `batchCount` (N/256) and, on a
sharded run, `ICI_bytes_per_device` (the bytes each shard received in one
run), beside the port's `launches/*`.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

OPS = ("hmult", "hadd", "hrotate", "pmult", "padd", "hsub", "hsquare")


def run_op(args) -> int:
    from .config import RunConfig
    from .params import get_params
    from .stats import Statistic, op_modmul_count

    if args.op not in OPS:
        print(f"unknown op {args.op!r} (expected {'|'.join(OPS)})",
              file=sys.stderr)
        return 1
    ns = args.cluster if args.cluster is not None else 1
    if ns <= 1 and args.dispatch in ("limb", "coeff", "hybrid"):
        print(f"--dispatch {args.dispatch} needs the [cluster] positional "
              "> 1 (the sharded paths are multi-device dispatches)",
              file=sys.stderr)
        return 1
    if ns > 1 and args.op not in ("hmult", "hrotate"):
        print(f"cluster={ns} {args.op}: the JAX CLI runs it through GSPMD, "
              "which is not ported to homulator_tpu_torch yet: ROADMAP A12",
              file=sys.stderr)
        return 2
    if ns > 1 and args.dispatch != "coeff":
        print(f"cluster={ns} --dispatch {args.dispatch}: only the "
              "coefficient dispatch (--dispatch coeff) is ported to "
              "homulator_tpu_torch yet; the others: ROADMAP A12",
              file=sys.stderr)
        return 2
    import torch

    from . import api as api_mod
    from . import kernels
    from .api import CkksEngine
    from .parallel.mesh import coeff_shard_ok, pack_k_for

    rc = RunConfig.from_cli(args.cfg, args.op, args.max_level, args.level,
                            args.alpha, args.cluster)
    cuda = torch.device(args.device).type == "cuda"
    name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else ""
    print(f"# device={args.device} {name}".rstrip())
    print(f"# N={rc.n} op={rc.op} maxLevel={rc.max_level} level={rc.level} "
          f"alpha={rc.alpha}")

    if args.fused_hpip or (rc.raw or {}).get("fused_hpip", 0):
        api_mod.USE_FUSED_HPIP = True  # main() restores the previous value
        print("# keyswitch=fused-hpip (ops/hpip.py, csrc/hpip.cu)")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    stats = Statistic()
    params = get_params(rc.n, rc.max_level, rc.alpha, rc.scale_bits)
    if ns > 1 and not coeff_shard_ok(params.ntt.n1, params.ntt.n2, ns):
        print(f"--dispatch coeff needs n1, n2 % {ns} == 0 and per-shard "
              f"tiles >= 8 (n1={params.ntt.n1}, n2={params.ntt.n2})",
              file=sys.stderr)
        return 1
    with stats.timer("setup/engine"):
        eng = CkksEngine(params, seed=args.seed, device=args.device)
    with stats.timer("setup/keygen"):
        eng.keygen()
        if rc.op == "hrotate":
            eng.gen_rotation_key(1)
    rng = np.random.default_rng(args.seed)
    slots = rc.n // 2
    v1 = rng.normal(size=slots)
    v2 = rng.normal(size=slots)
    scale = float(1 << rc.scale_bits)
    with stats.timer("setup/encrypt"):
        ct1 = eng.encrypt_complex(v1, rc.level, scale)
        ct2 = eng.encrypt_complex(v2, rc.level, scale)
        pt2 = eng.plaintext_complex(v2, rc.level, scale)

    def op_once():
        if rc.op == "hmult":
            return eng.hmult(ct1, ct2)
        if rc.op == "hadd":
            return eng.hadd(ct1, ct2)
        if rc.op == "hrotate":
            return eng.hrotate(ct1, 1)
        if rc.op == "pmult":
            return eng.pmult(ct1, pt2)
        if rc.op == "padd":
            return eng.padd(ct1, pt2)
        if rc.op == "hsub":
            return eng.hsub(ct1, ct2)
        return eng.hsquare(ct1)

    single = op_once
    if ns > 1:
        op_once, mesh, ici = _coeff_op(eng, rc, ns, ct1, ct2)
        k = pack_k_for(params.ntt.n1, params.ntt.n2, ns)
        print(f"# dispatch=coeff mesh=ThreadMesh({ns} shards on one "
              f"{args.device} device) ici_bytes_per_shard={ici} "
              + (f"ntt=lane-packed k={k} (B10-B13)" if k
                 else "ntt=per-limb (B6-B9)"))

    with stats.timer("first_run"):  # includes the kernel build on a GPU
        out = op_once()
        sync()
    kernels.reset_launch_counts()
    if ns > 1:
        mesh.reset_counts()
    for _ in range(args.iters):
        t0 = time.perf_counter()
        out = op_once()
        sync()
        stats.record_time(f"op/{rc.op}", time.perf_counter() - t0)
    for k, v in kernels.LAUNCHES.items():
        stats.set(f"launches/{k}", v)
    if ns > 1:
        # bytes each shard received per run: ici_bytes_per_op's count
        got = mesh.recv_bytes
        stats.set("ICI_bytes_per_device", ici)
        if got != [ici * args.iters] * ns:
            print(f"shards received {got} bytes in {args.iters} runs, "
                  f"ici_bytes_per_op gives {ici} a run", file=sys.stderr)
            return 1
    stats.set("modmul_count", op_modmul_count(
        rc.op, rc.n, rc.level, rc.alpha, params.beta(rc.level)))
    stats.set("limbs", rc.level)
    stats.set("batchCount", rc.n // 256)  # reference batch granularity

    if args.verify:
        if ns > 1:
            same = torch.equal(out.data, single().data)
            print(f"# coeff dispatch == single-device {rc.op}: "
                  + ("bit-exact" if same else "DIFFERS"))
            if not same:
                return 1
        with stats.timer("verify/decrypt"):
            got = eng.decrypt_complex(out)
        expected = {"hmult": v1 * v2, "hadd": v1 + v2,
                    "hrotate": np.roll(v1, -1), "pmult": v1 * v2,
                    "padd": v1 + v2, "hsub": v1 - v2,
                    "hsquare": v1 * v1}[rc.op]
        err = float(np.max(np.abs(got - expected)))
        print(f"# verify max-abs-err = {err:.3e}")
        if err > 1e-2:
            print("VERIFY FAILED", file=sys.stderr)
            return 1

    if args.iters:
        lat_ms = 1e3 * min(stats.timings[f"op/{rc.op}"])
        print(f"FHE-Op {rc.op} latency: {lat_ms:.3f} ms "
              f"({1e3 / lat_ms:.1f} ops/s) on {args.device}")
    stats.show()
    return 0


def _coeff_op(eng, rc, ns, ct1, ct2):
    """(op_once, mesh, ici): the op of rc coefficient-sharded over a
    ThreadMesh of ns shards on the engine's device, its operands and key
    sharded once here; op_once gathers the result into a Ciphertext."""
    from .context import Ciphertext
    from .parallel.comm import ThreadMesh
    from .parallel.sharded import (
        gather_cols, ici_bytes_per_op, make_shardmap_hmult,
        make_shardmap_hrotate, shard_cols,
    )

    params = eng.params
    mesh = ThreadMesh(ns, eng.dc.device)
    a = shard_cols(ct1.data, ns)
    if rc.op == "hmult":
        f = make_shardmap_hmult(eng.dc, rc.level, mesh)
        b, key = shard_cols(ct2.data, ns), shard_cols(eng.relin_key, ns)
        ici = ici_bytes_per_op(params, rc.level, ns, "hmult")

        def op_once():
            return Ciphertext(gather_cols(f(a, b, key)), rc.level - 1,
                              ct1.scale * ct2.scale / params.qs[rc.level - 1])
    else:
        f = make_shardmap_hrotate(eng.dc, rc.level, mesh)
        route = eng.dc.automorph_shard_route(params.galois_elt(1), ns)
        key = shard_cols(eng.rot_keys[1], ns)
        ici = ici_bytes_per_op(params, rc.level, ns, "hrotate",
                               route_identity=route[2])

        def op_once():
            return Ciphertext(gather_cols(f(a, route, key)), rc.level,
                              ct1.scale)
    return op_once, mesh, ici


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="homulator_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run", help="run one FHE operation (reference "
                                      "CLI contract)")
    runp.add_argument("cfg")
    runp.add_argument("op")
    runp.add_argument("max_level", type=int)
    runp.add_argument("level", type=int)
    runp.add_argument("alpha", type=int)
    runp.add_argument("cluster", type=int, nargs="?", default=None,
                      help="shard count; above 1 with --dispatch coeff")
    runp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                      help="cuda: the CUDA kernels; cpu: their plain "
                           "PyTorch versions")
    runp.add_argument("--iters", type=int, default=5)
    runp.add_argument("--seed", type=int, default=0)
    runp.add_argument("--verify", action="store_true")
    runp.add_argument("--fused-hpip", action="store_true",
                      help="route key switches through the fused HPIP "
                           "kernel B4 (also cfg key fused_hpip = 1)")
    runp.add_argument("--dispatch", default="auto",
                      choices=["auto", "limb", "coeff", "hybrid", "gspmd"],
                      help="multi-device dispatch for [cluster] > 1; only "
                           "coeff is ported (ROADMAP A12)")
    args = ap.parse_args(argv)
    from . import api as api_mod

    prev_fused = api_mod.USE_FUSED_HPIP
    try:
        return run_op(args)
    finally:
        api_mod.USE_FUSED_HPIP = prev_fused


if __name__ == "__main__":
    raise SystemExit(main())
