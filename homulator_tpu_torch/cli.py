"""CLI: `python -m homulator_tpu_torch run <cfg> <op> <maxLevel> <level>
<alpha> [cluster] [--verify] [--device cuda|cpu] [--platform cpu|gpu|cuda]
[--fused-hpip] [--dispatch auto|limb|coeff|hybrid|gspmd] [--profile DIR]
[--cache-dir DIR]`.

The reference's positional contract, as in `homulator_tpu/cli.py`: its
five operations hmult, hadd, hrotate (by one step), pmult and padd, and
the JAX CLI's hsub and hsquare; pmult and padd take the plaintext of the
second operand's slots. An unknown op (with the JAX CLI's message) and a
usage error (`--dispatch limb|coeff|hybrid` without a [cluster] above 1,
a tile that `coeff_shard_ok` rejects, an unknown `--platform`) exit with
status 1, as the JAX CLI's `SystemExit` does. `--verify` decrypts every
slot and prints the JAX CLI's `# verify max-abs-err = ...` line against
the same expectations; an error above 1e-2 exits with 1. The key switches
take the accelerated route (the graph route is the engine's
ntt_mode="jnp"). `--fused-hpip` (or the cfg key `fused_hpip = 1`) routes
key switches through the fused HPIP kernel (api.USE_FUSED_HPIP) for the
run and restores the flag afterwards.

The JAX CLI's runtime flags map onto the port's: `--platform` names the
device as JAX names its platforms (cpu: the kernels' plain versions; gpu
or cuda: the CUDA kernels; any other name, or one that contradicts an
explicit `--device`, exits 1); `--cache-dir DIR` is where the kernels are
built and loaded (kernels.BUILD_DIR, default build/kernels/), the
counterpart of the JAX compile cache; `--profile DIR` wraps the timed
iterations in torch.profiler (CPU activity, and CUDA activity on the
card), writes a Chrome trace into DIR, which shows the op's spans
(stats.span) with their kernels under them, and prints the span table:
calls, host and device self ms and kernel launches by span name.

A [cluster] positional above 1 runs the op on a ThreadMesh of [cluster]
shards on the chosen device (all shards on one device: not a
multi-device run). hmult, hsquare and hrotate take a key-switch dispatch:

  limb    RNS rows sharded (parallel/limb_sharded.py, the reference's
          primary dispatch): whole-limb NTTs (B1, B2) and base
          conversions (B3) per shard, row-block all_gathers between them;
  coeff   the coefficient axis sharded (parallel/sharded.py), routed as
          the JAX CLI routes it (`make_shardmap_*`'s default: the
          lane-packed phase kernels where `pack_k_for` > 0, e.g. 8 to 32
          shards at N = 2^16), where `coeff_shard_ok` allows it;
  hybrid  a ([cluster]/2 limb x 2 coeff) mesh (`make_hybrid_*`), for an
          even [cluster] >= 4 and a tile that splits 2-way: the limb
          programs with every transform phase-split (B6-B9);
  auto    (the default) limb, coeff or hybrid by the projected-time
          model (`dispatch_model.choose_axis`, and `predict_hybrid_ms`
          for the [cluster]/2 x 2 hybrid) over the H100's per-shard
          anchors (`parallel/_scaling_measured.py`, measured at set B by
          scripts/scaling_projection_torch.py), printing each predicted
          T; at params without anchors, the axis whose shards receive
          fewer bytes ("picked by ICI volume (no model anchors)"). The
          JAX CLI picks by its TPU model, so the two CLIs may take
          different axes for one shape;
  gspmd   the layout the JAX CLI hands its partitioner (rows over the
          mesh), run as the limb dispatch's explicit program
          (parallel/sharded.py says why the port has no partitioner).

hsquare runs hmult's dispatch with the ciphertext as both operands: every
residue is canonical, so a0*a1 + a1*a0 = 2*a0*a1 mod q and the result is
hsquare's, bit for bit. hadd, hsub, padd and pmult take no key switch and,
as in the JAX CLI, ignore `--dispatch`: each shard runs the engine's
elementwise graph on its slice, the rows over the mesh where [cluster]
divides level and the n2 axis otherwise (`make_sharded_elementwise`);
no collective runs.

A sharded run prints the JAX CLI's `ici/device: limb=..., coeff=... ->
<axis>` comparison for a key switch, checks the bytes each shard received
against the exact count of its dispatch (`ici_bytes_per_op`, `_limb`,
`_hybrid`; 0 for the elementwise ops), and with `--verify` the result
against the single-device op bit for bit.

The stat table has the JAX CLI's keys: `batchCount` (N/256); on a
single-device run the op's counters (`CkksEngine.op_cost_counters`:
HBM_bytes, counted; MEM_arg_bytes, MEM_out_bytes and, on the card,
MEM_temp_bytes) and `HBM_GBps_achieved` (HBM_bytes over the best time);
on a sharded run `ICI_bytes_per_device` (the bytes each shard received in
one run) in their place; and the port's `launches/*`.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

OPS = ("hmult", "hadd", "hrotate", "pmult", "padd", "hsub", "hsquare")
KEYSWITCH_OPS = ("hmult", "hrotate", "hsquare")
# the JAX platform names the port runs on, and their torch devices
PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def _device(args):
    """(device, None) from --platform and --device, or (None, the usage
    error's message)."""
    if args.platform is None:
        return args.device or "cuda", None
    dev = PLATFORMS.get(args.platform)
    if dev is None:
        return None, (f"--platform {args.platform}: the port runs on "
                      f"{'|'.join(PLATFORMS)}")
    if args.device is not None and args.device != dev:
        return None, (f"--platform {args.platform} runs on {dev}, "
                      f"--device says {args.device}")
    return dev, None


def run_op(args) -> int:
    from .config import RunConfig
    from .params import get_params
    from .stats import Statistic, op_modmul_count

    if args.op not in OPS:
        print(f"unknown op {args.op!r} (expected {'|'.join(OPS)})",
              file=sys.stderr)
        return 1
    device, err = _device(args)
    if err:
        print(err, file=sys.stderr)
        return 1
    ns = args.cluster if args.cluster is not None else 1
    if ns <= 1 and args.dispatch in ("limb", "coeff", "hybrid"):
        print(f"--dispatch {args.dispatch} needs the [cluster] positional "
              "> 1 (the sharded paths are multi-device dispatches)",
              file=sys.stderr)
        return 1
    import torch

    from . import api as api_mod
    from . import kernels
    from .api import CkksEngine

    rc = RunConfig.from_cli(args.cfg, args.op, args.max_level, args.level,
                            args.alpha, args.cluster)
    cuda = torch.device(device).type == "cuda"
    name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else ""
    print(f"# device={device} {name}".rstrip())
    print(f"# N={rc.n} op={rc.op} maxLevel={rc.max_level} level={rc.level} "
          f"alpha={rc.alpha}")
    if args.cache_dir:
        kernels.BUILD_DIR = os.path.abspath(args.cache_dir)  # main restores
    print(f"# kernel cache: {kernels.BUILD_DIR}")

    if args.fused_hpip or (rc.raw or {}).get("fused_hpip", 0):
        api_mod.USE_FUSED_HPIP = True  # main() restores the previous value
        print("# keyswitch=fused-hpip (ops/hpip.py, csrc/hpip.cu)")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    stats = Statistic()
    params = get_params(rc.n, rc.max_level, rc.alpha, rc.scale_bits)
    keyswitch = ns > 1 and rc.op in KEYSWITCH_OPS
    if keyswitch:
        pick = _pick_dispatch(params, rc, ns, args.dispatch)
        if isinstance(pick, str):
            print(pick, file=sys.stderr)
            return 1
    with stats.timer("setup/engine"):
        eng = CkksEngine(params, seed=args.seed, device=device)
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
    if keyswitch:
        axis, label, note = pick
        b = ct1 if rc.op == "hsquare" else ct2
        op_once, mesh, ici, desc = _sharded_op(eng, rc, ns, axis, ct1, b)
        why = f" ({_GSPMD_REASON})" if args.dispatch == "gspmd" else ""
        print(f"# dispatch={label}{why} mesh=({desc}) ThreadMesh on one "
              f"{device} device ici_bytes_per_device={ici} {note}")
    elif ns > 1:
        label = "gspmd"
        op_once, mesh, desc = _elementwise_op(eng, rc, ns, ct1, ct2, pt2)
        ici = 0
        print(f"# dispatch=gspmd mesh=({desc}) ThreadMesh on one {device} "
              "device ici_bytes_per_device=0 (the engine's elementwise "
              "graph on each shard's slice, no collective; --dispatch "
              "applies to the key switches only)")
    with stats.timer("first_run"):  # includes the kernel build on a GPU
        out = op_once()
        sync()
    kernels.reset_launch_counts()
    if ns > 1:
        mesh.reset_counts()
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []))
    with prof if prof is not None else contextlib.nullcontext():
        for _ in range(args.iters):
            t0 = time.perf_counter()
            out = op_once()
            sync()
            stats.record_time(f"op/{rc.op}", time.perf_counter() - t0)
    if prof is not None:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            args.profile, f"homulator_tpu_torch_{rc.op}.json"))
        print(f"# profiler trace written to {args.profile}")
        print_span_table(args.iters)
    for k, v in kernels.LAUNCHES.items():
        stats.set(f"launches/{k}", v)
    if ns > 1:
        # bytes each shard received per run: its dispatch's exact count
        got = mesh.recv_bytes
        stats.set("ICI_bytes_per_device", ici)
        if got != [ici * args.iters] * len(mesh.comms):
            print(f"shards received {got} bytes in {args.iters} runs, "
                  f"the {label} dispatch's count gives {ici} a run",
                  file=sys.stderr)
            return 1
    stats.set("modmul_count", op_modmul_count(
        rc.op, rc.n, rc.level, rc.alpha, params.beta(rc.level)))
    stats.set("limbs", rc.level)
    stats.set("batchCount", rc.n // 256)  # reference batch granularity
    if ns > 1:
        print("# op cost counters unavailable: sharded run (they count one "
              "single-device run): see ICI_bytes_per_device")
    else:
        cc = eng.op_cost_counters(rc.op, ct1, ct2, pt2)
        for k, v in cc.items():
            stats.set(k, v)
        if args.iters:
            best = min(stats.timings[f"op/{rc.op}"])
            stats.set("HBM_GBps_achieved", cc["HBM_bytes"] / best / 1e9)

    if args.verify:
        if ns > 1:
            same = torch.equal(out.data, single().data)
            print(f"# {label} dispatch == single-device {rc.op}: "
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
              f"({1e3 / lat_ms:.1f} ops/s) on {device}")
    stats.show()
    return 0


def print_span_table(iters: int) -> None:
    """The profiled runs' spans (stats.span_table) by name: calls, host
    and device self ms (device on the card only) and the port's kernel
    launches, each over all `iters` runs."""
    from .stats import span_table, spans

    rows = span_table(spans())
    if not rows:
        print("# spans: none recorded (the op records spans on the "
              "accelerated route only)")
        return
    print(f"# spans over {iters} run(s): self time is a span's own time "
          "less its children's")
    print("%-24s %6s %14s %16s %9s" % ("span", "calls", "host_self_ms",
                                       "device_self_ms", "launches"))
    for r in rows:
        dev = ("%16.3f" % r["device_self_ms"]
               if r["device_self_ms"] is not None else "%16s" % "-")
        print("%-24s %6d %14.3f %s %9d" % (r["span"], r["calls"],
                                          r["host_self_ms"], dev,
                                          r["launches"]))


_GSPMD_REASON = ("the JAX CLI's GSPMD layout, rows over the mesh, run as the "
                 "limb dispatch's explicit program")


def _pick_dispatch(params, rc, ns, dispatch):
    """(axis, label, note) of a key-switch op at ns shards: the forced
    axis (gspmd: limb), or auto's pick (dispatch_model.choose_axis), and
    the JAX CLI's `ici/device: ...` comparison; or the usage error's
    message. hsquare is billed as hmult, whose dispatch it runs."""
    from .ops.automorph import BlockAlignmentError, build_shard_route
    from .parallel.dispatch_model import choose_axis, predict_hybrid_ms
    from .parallel.limb_sharded import ici_bytes_per_op_limb
    from .parallel.mesh import coeff_shard_ok, pack_k_for
    from .parallel.sharded import ici_bytes_per_op

    op = "hmult" if rc.op == "hsquare" else rc.op
    n1, n2 = params.ntt.n1, params.ntt.n2
    coeff_ok = coeff_shard_ok(n1, n2, ns)
    hybrid_ok = ns >= 4 and ns % 2 == 0 and coeff_shard_ok(n1, n2, 2)
    if dispatch == "coeff" and not coeff_ok:
        return (f"--dispatch coeff needs n1,n2 % {ns} == 0 and per-shard "
                f"tiles >= 8 (n1={n1}, n2={n2})")
    if dispatch == "hybrid" and not hybrid_ok:
        return ("--dispatch hybrid needs an even cluster >= 4 and a "
                "2-way-shardable coefficient tile")
    # hrotate(1)'s automorphism may be an exchange-free identity route at
    # the coeff shard count (at ns here, at 2 in the hybrid's coeff group)
    ident = {}
    for m in (ns, 2):
        try:
            ident[m] = op == "hrotate" and n1 % m == 0 and \
                build_shard_route(params.automorph_eval_perm(
                    params.galois_elt(1)), n2, n1, m)[2]
        except BlockAlignmentError:
            ident[m] = False
    ici_limb = ici_bytes_per_op_limb(params, rc.level, ns, op)
    ici_coeff = (ici_bytes_per_op(params, rc.level, ns, op,
                                  route_identity=ident[ns])
                 if coeff_ok else None)
    pred = ""
    label = dispatch
    if dispatch == "auto":
        dispatch, t_l, t_c, how = choose_axis(
            params, op, ns, rc.level, coeff_ok=coeff_ok,
            route_identity=ident[ns])
        if how == "model":
            t_h = (predict_hybrid_ms(params, op, ns // 2, 2, rc.level,
                                     route_identity=ident[2])
                   if hybrid_ok else None)
            if t_h is not None and t_h <= min(
                    t for t in (t_l, t_c) if t is not None):
                dispatch = "hybrid"
            pred = (f"; predicted T: limb={t_l:.3f} ms, coeff="
                    + (f"{t_c:.3f} ms" if t_c is not None else "n/a")
                    + (f", hybrid({ns // 2}x2)={t_h:.3f} ms"
                       if t_h is not None else ""))
        else:
            pred = "; picked by ICI volume (no model anchors)"
        forced = ""
        label = dispatch
    elif dispatch == "gspmd":
        dispatch, forced, label = "limb", " (gspmd)", "gspmd -> limb"
    else:
        forced = " (forced)"
    k = pack_k_for(n1, n2, ns)
    ntt = {"limb": "ntt=whole-limb (B1, B2)",
           "hybrid": "ntt=per-limb phases (B6-B9)",
           "coeff": (f"ntt=lane-packed k={k} (B10-B13)" if k
                     else "ntt=per-limb (B6-B9)")}[dispatch]
    both = (f"ici/device: limb={ici_limb / 1e6:.2f} MB, coeff="
            + (f"{ici_coeff / 1e6:.2f} MB" if ici_coeff is not None
               else "n/a (tile shape)") + f" -> {dispatch}{forced}{pred}")
    return dispatch, label, f"{ntt} — {both}"


def _sharded_op(eng, rc, ns, axis, ct1, ct2):
    """(op_once, mesh, ici, mesh description): the key-switch op of rc
    (hsquare: hmult with ct2 = ct1) on `axis` over a ThreadMesh of ns
    shards on the engine's device, its operands and key laid out once
    here; op_once gathers the result into a Ciphertext."""
    from .context import Ciphertext
    from .parallel import limb_sharded as ls
    from .parallel.comm import ThreadMesh
    from .parallel.sharded import (
        gather_cols, ici_bytes_per_op, make_shardmap_hmult,
        make_shardmap_hrotate, shard_cols,
    )

    params, dc, level = eng.params, eng.dc, rc.level
    g = params.galois_elt(1)
    mult = rc.op != "hrotate"
    key = eng.relin_key if mult else eng.rot_keys[1]
    if mult:
        out_level = level - 1
        scale = ct1.scale * ct2.scale / params.qs[level - 1]
    else:
        out_level, scale = level, ct1.scale
    if axis == "coeff":
        mesh = ThreadMesh(ns, dc.device)
        a, k = shard_cols(ct1.data, ns), shard_cols(key, ns)
        if mult:
            f, b = make_shardmap_hmult(dc, level, mesh), shard_cols(
                ct2.data, ns)
            run = lambda: f(a, b, k)  # noqa: E731
            ici = ici_bytes_per_op(params, level, ns, "hmult")
        else:
            f = make_shardmap_hrotate(dc, level, mesh)
            route = dc.automorph_shard_route(g, ns)
            run = lambda: f(a, route, k)  # noqa: E731
            ici = ici_bytes_per_op(params, level, ns, "hrotate",
                                   route_identity=route[2])
        return (lambda: Ciphertext(gather_cols(run()), out_level, scale),
                mesh, ici, f"{ns} coeff")
    ns_l, ns_c = (ns, 1) if axis == "limb" else (ns // 2, 2)
    if axis == "limb":
        mesh = ThreadMesh(ns, dc.device, names=("limb",))
        desc = f"{ns} limb"
    else:
        mesh = ThreadMesh((ns_l, ns_c), dc.device, names=("limb", "coeff"))
        desc = f"{ns_l} limb, {ns_c} coeff"
    a = ls.shard_rows(ct1.data, level, ns_l, ns_c)
    k = ls.limb_key(key, params, level, ns_l, ns_c)
    if mult:
        make = ls.make_limb_hmult if axis == "limb" else ls.make_hybrid_hmult
        f, b = make(dc, level, mesh), ls.shard_rows(ct2.data, level, ns_l,
                                                    ns_c)
        run = lambda: f(a, b, k)  # noqa: E731
        ici = (ls.ici_bytes_per_op_limb(params, level, ns, "hmult")
               if axis == "limb" else
               ls.ici_bytes_per_op_hybrid(params, level, ns_l, ns_c, "hmult"))
    elif axis == "limb":
        f = ls.make_limb_hrotate(dc, level, mesh)
        perm = dc.automorph_perm(g)
        run = lambda: f(a, perm, k)  # noqa: E731
        ici = ls.ici_bytes_per_op_limb(params, level, ns, "hrotate")
    else:
        f = ls.make_hybrid_hrotate(dc, level, mesh)
        route = dc.automorph_shard_route(g, ns_c)
        run = lambda: f(a, route, k)  # noqa: E731
        ici = ls.ici_bytes_per_op_hybrid(params, level, ns_l, ns_c,
                                         "hrotate", route_identity=route[2])

    def op_once():
        data = ls.gather_rows(run(), ns_l, ns_c)[:, :out_level]
        return Ciphertext(data.contiguous(), out_level, scale)
    return op_once, mesh, ici, desc


def _elementwise_op(eng, rc, ns, ct1, ct2, pt2):
    """(op_once, mesh, mesh description): hadd, hsub, padd or pmult over a
    ThreadMesh of ns shards, laid out as the JAX CLI lays them out for
    GSPMD (rows over the mesh where ns divides level, else n2); operands
    cut once here, op_once joins the slices into a Ciphertext."""
    import torch

    from .context import Ciphertext
    from .parallel.comm import ThreadMesh
    from .parallel.sharded import (
        elementwise_axis, make_sharded_elementwise, shard_elementwise,
    )

    level = rc.level
    axis = elementwise_axis(level, ns)
    mesh = ThreadMesh(ns, eng.dc.device)
    f = make_sharded_elementwise(eng.dc, rc.op, level, mesh)
    plain = rc.op in ("padd", "pmult")
    a = shard_elementwise(ct1.data, axis, ns)
    # a plaintext [level, n2, n1] is cut along the same axis, from its end
    b = shard_elementwise((pt2 if plain else ct2).data, axis, ns)
    scale = ct1.scale * pt2.scale if rc.op == "pmult" else ct1.scale

    def op_once():
        return Ciphertext(torch.cat(f(a, b), dim=axis), level, scale)
    return op_once, mesh, f"{ns} {'rows' if axis == -3 else 'n2'}"


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
                      help="shard count; above 1 a sharded dispatch")
    runp.add_argument("--device", default=None, choices=["cuda", "cpu"],
                      help="cuda (the default): the CUDA kernels; cpu: "
                           "their plain PyTorch versions")
    runp.add_argument("--platform", default=None,
                      help="the JAX CLI's platform name: cpu, or gpu / "
                           "cuda (the card); sets --device")
    runp.add_argument("--iters", type=int, default=5)
    runp.add_argument("--seed", type=int, default=0)
    runp.add_argument("--verify", action="store_true")
    runp.add_argument("--profile", default=None,
                      help="write a torch.profiler Chrome trace of the "
                           "timed iterations into this directory")
    runp.add_argument("--cache-dir", default=None,
                      help="where the kernels are built and loaded "
                           "(default build/kernels/)")
    runp.add_argument("--fused-hpip", action="store_true",
                      help="route key switches through the fused HPIP "
                           "kernel B4 (also cfg key fused_hpip = 1)")
    runp.add_argument("--dispatch", default="auto",
                      choices=["auto", "limb", "coeff", "hybrid", "gspmd"],
                      help="multi-device dispatch of the key switches for "
                           "[cluster] > 1 (gspmd: the JAX CLI's layout, "
                           "run as the limb dispatch)")
    args = ap.parse_args(argv)
    from . import api as api_mod
    from . import kernels

    prev_fused, prev_build = api_mod.USE_FUSED_HPIP, kernels.BUILD_DIR
    try:
        return run_op(args)
    finally:
        api_mod.USE_FUSED_HPIP = prev_fused
        kernels.BUILD_DIR = prev_build


if __name__ == "__main__":
    raise SystemExit(main())
