#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`homulator_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper, sm_90a), `nvcc` and this checkout; imports no
JAX. Every phase raises on failure and the script then exits non-zero:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build (nvcc) and its time;
  3. each CUDA kernel against its plain PyTorch version on the card, at the
     shapes hmult(45,35,15) gives it (and the NTT at M = 35, 50, 15 with
     rep = 2), bit for bit, with the device time of each (CUDA graph
     replay between CUDA events, so host overhead is excluded);
  4. an independent oracle: the exact numpy engine's hmult
     (`RefCkks.hmult`) equals the port's hmult and hsquare on the card, bit
     for bit, at N = 2^13 (n1 = 64 != n2 = 128), maxLevel 8, level 8,
     alpha 3 (a partial digit);
  5. parameter set B, hmult(45,35,15) (N = 2^16, 45 main + 15 special
     primes) through `CkksEngine(device="cuda")`: equal to the plain path
     (the same engine on the CPU) bit for bit, every kernel launched, all
     32768 slots decrypted within 1e-2 of v1*v2 (and of v1*v1 for
     hsquare); hmult and hsquare latency (CUDA events around eager calls,
     median of 20 runs after warm-up) and their device time (graph replay);
  6. one JSON line of per-kernel results (each kernel's times at one shape
     that hmult(45,35,15) launches, named in `shape`; `max_abs_err` over
     every shape checked), then the device line last.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SET_B = dict(n=1 << 16, max_level=45, alpha=15)
LEVEL_B = 35
SCALE = float(1 << 29)
GATE = 1e-2


def latency_ms(torch, fn, iters=20, warmup=3):
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


def device_ms(torch, fn, calls=10, replays=20):
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


def random_residues(np, torch, rng, q, shape):
    """int32 tensor on the GPU: uniform residues, row i mod q[i]."""
    q = np.asarray(q, dtype=np.int64)
    x = rng.integers(0, q.reshape((-1,) + (1,) * (len(shape) - 1)),
                     size=shape, dtype=np.int64)
    return torch.from_numpy(x.astype(np.int32)).cuda()


def check_kernels(np, torch, dc, kt, rng, results):
    """Phase 3: every kernel vs its plain version at the set-B shapes."""
    from homulator_tpu_torch.ops import ntt_kernels
    from homulator_tpu_torch.ops.bconv_fused import bconv_fused, bconv_plain
    from homulator_tpu_torch.ops.ntt import intt_plain, ntt_plain

    n1, n2 = dc.params.ntt.n1, dc.params.ntt.n2
    ext_nt = dc.ntt_basis(dc.ext_rows(LEVEL_B))
    d0, d2 = kt.digits[0], kt.digits[2]
    ntt_cases = {  # label -> (basis, rep)
        "main M=35 rep=2": (kt.main_nt, 2),
        "ext M=50 rep=2": (ext_nt, 2),
        "special M=15 rep=2": (kt.special_nt, 2),
    }
    fwd_cases = dict(ntt_cases, **{
        "digit0 other M=35 rep=1": (d0.other_nt, 1),
        "digit2 other M=45 rep=1": (d2.other_nt, 1),
        "tail out M=34 rep=2": (kt.tail.out_nt, 2),
    })
    inv_cases = dict(ntt_cases, **{
        "main M=35 rep=1": (kt.main_nt, 1),
        "tail last M=1 rep=2": (kt.tail.last_nt, 2),
    })
    for name, kernel, plain, cases, shape in (
            ("ntt_fwd", ntt_kernels.ntt_fwd, ntt_plain, fwd_cases, (n1, n2)),
            ("ntt_inv", ntt_kernels.ntt_inv, intt_plain, inv_cases,
             (n2, n1))):
        for label, (nb, rep) in cases.items():
            q = np.tile(nb.q.cpu().numpy(), rep)
            x = random_residues(np, torch, rng, q, (len(q),) + shape)
            got = kernel(x, nb, rep)
            want = plain(x, nb, rep)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            if err:
                raise AssertionError(f"{name} {label}: differs by {err}")
            ms = device_ms(torch, lambda: kernel(x, nb, rep))
            plain_ms = device_ms(torch, lambda: plain(x, nb, rep))
            print(f"# {name} {label}: bit-exact (tolerance 0), kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms")
            results[name].append((label, err, ms, plain_ms))

    cases = {}
    for d, dt in enumerate(kt.digits):
        cases[f"modup digit{d} {dt.hi - dt.lo}+1->{dt.mat.shape[0]}"] = (
            dt.in_q, (dt.step1, dt.step1_sh, dt.in_q, dt.mat, dt.mat_sh,
                      dt.other_nt.q), True)
    tt = kt.tail
    cases[f"tail {tt.in_q.shape[0]}->{tt.mat.shape[0]}"] = (
        tt.in_q, (tt.one, tt.one_sh, tt.in_q, tt.mat, tt.mat_sh,
                  tt.out_nt.q), False)
    for label, (in_q, tabs, center) in cases.items():
        x = random_residues(np, torch, rng, in_q.cpu().numpy(),
                            (in_q.shape[0], n1, n2))
        s, s_sh, iq, mat, mat_sh, out_q = tabs
        got = bconv_fused(x, s, s_sh, iq, mat, mat_sh, out_q, center=center)
        want = bconv_plain(x, s, iq, mat, out_q, center)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err:
            raise AssertionError(f"bconv {label}: differs by {err}")
        ms = device_ms(torch, lambda: bconv_fused(
            x, s, s_sh, iq, mat, mat_sh, out_q, center=center))
        plain_ms = device_ms(
            torch, lambda: bconv_plain(x, s, iq, mat, out_q, center))
        print(f"# bconv {label}: bit-exact (tolerance 0), kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        results["bconv"].append((label, err, ms, plain_ms))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from homulator_tpu_torch import kernels
    from homulator_tpu_torch.api import CkksEngine, get_params
    from homulator_tpu_torch.context import Ciphertext

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. kernel build
    t0 = time.perf_counter()
    nvcc_s = kernels.build()
    kernels.load()
    print(f"# kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {nvcc_s:.1f} s) -> {os.path.relpath(kernels.library_path(), ROOT)}")
    with open(kernels.library_path()[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "Compiling entry" in line:
                print("#   " + line.strip())

    # 3. kernels vs plain versions at the set-B shapes
    t0 = time.perf_counter()
    params = get_params(**SET_B)
    print(f"# set B params: {time.perf_counter() - t0:.1f} s")
    eng = CkksEngine(params, seed=1, device="cuda")
    kt = eng.dc.keyswitch_tables(LEVEL_B)
    results = {"ntt_fwd": [], "ntt_inv": [], "bconv": []}
    check_kernels(np, torch, eng.dc, kt, np.random.default_rng(2), results)

    # 4. independent oracle at a mid size with a partial digit
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
    ref = em.ref.hmult(em.to_ref(a), em.to_ref(a))
    if not np.array_equal(ref.data, em.dc.download(em.hsquare(a).data)):
        raise AssertionError("hsquare(8,8,3) at N=2^13 != RefCkks.hmult(a, a)")
    print("# oracle N=2^13 L8 l8 a3: hmult and hsquare == RefCkks, bit-exact")

    # 5. set B through the engine
    t0 = time.perf_counter()
    eng.keygen()
    rng = np.random.default_rng(7)
    slots = params.n // 2
    v1, v2 = rng.normal(size=slots), rng.normal(size=slots)
    ct1 = eng.encrypt_complex(v1, LEVEL_B, SCALE)
    ct2 = eng.encrypt_complex(v2, LEVEL_B, SCALE)
    print(f"# set B keygen + encrypt (host numpy): "
          f"{time.perf_counter() - t0:.1f} s")
    kernels.reset_launch_counts()
    out = eng.hmult(ct1, ct2)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"# hmult(45,35,15) kernel launches: {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched by hmult: {missing}")
    cpu = CkksEngine(params, seed=1, device="cpu")  # the plain path
    cpu.relin_key = eng.relin_key.cpu()
    t0 = time.perf_counter()
    out_cpu = cpu.hmult(
        *(Ciphertext(c.data.cpu(), c.level, c.scale) for c in (ct1, ct2)))
    print(f"# plain path (CPU) hmult: {time.perf_counter() - t0:.1f} s")
    if not torch.equal(out.data.cpu(), out_cpu.data):
        raise AssertionError("hmult(45,35,15): GPU != CPU plain path")
    err_mult = float(np.max(np.abs(eng.decrypt_complex(out) - v1 * v2)))
    sq = eng.hsquare(ct1)
    err_sq = float(np.max(np.abs(eng.decrypt_complex(sq) - v1 * v1)))
    print(f"# verify max-abs-err = {err_mult:.3e} (hmult), {err_sq:.3e} "
          f"(hsquare), all {slots} slots")
    if not (err_mult < GATE and err_sq < GATE):
        raise AssertionError(f"decrypt gate {GATE} failed")
    torch.cuda.reset_peak_memory_stats()
    hmult_ms = latency_ms(torch, lambda: eng.hmult(ct1, ct2))
    hsquare_ms = latency_ms(torch, lambda: eng.hsquare(ct1))
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"# hmult(45,35,15) {hmult_ms:.3f} ms, hsquare {hsquare_ms:.3f} ms "
          f"(eager calls: CUDA events, median of 20 after 3 warm-up runs; "
          f"peak memory {peak:.0f} MiB)")
    hmult_dev = device_ms(torch, lambda: eng.hmult(ct1, ct2), calls=2)
    hsquare_dev = device_ms(torch, lambda: eng.hsquare(ct1), calls=2)
    print(f"# device time without host overhead (CUDA graph replay): hmult "
          f"{hmult_dev:.3f} ms, hsquare {hsquare_dev:.3f} ms")

    # 6. results
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    replaces = {
        "ntt_fwd": ("homulator_tpu_torch/csrc/ntt.cu",
                    "homulator_tpu/ops/ntt_pallas.py:244"),
        "ntt_inv": ("homulator_tpu_torch/csrc/ntt.cu",
                    "homulator_tpu/ops/ntt_pallas.py:677"),
        "bconv": ("homulator_tpu_torch/csrc/bconv.cu",
                  "homulator_tpu/ops/bconv_fused.py:131"),
    }
    # headline shape of each kernel: one that hmult(45,35,15) launches
    headline = {"ntt_fwd": "tail out M=34 rep=2", "ntt_inv": "main M=35 rep=1",
                "bconv": next(r[0] for r in results["bconv"])}
    rows = []
    for name, res in results.items():
        ms, plain_ms = next(r[2:] for r in res if r[0] == headline[name])
        rows.append({
            "name": name, "route": "cuda", "source": replaces[name][0],
            "replaces": replaces[name][1], "shape": headline[name],
            "launches": launches[name],
            "max_abs_err": max(r[1] for r in res), "ms": ms,
            "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": rows, "hmult_ms": hmult_ms,
                      "hsquare_ms": hsquare_ms, "hmult_device_ms": hmult_dev,
                      "hsquare_device_ms": hsquare_dev,
                      "verify_max_err": err_mult}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
