"""CLI contract of the port (`python -m homulator_tpu_torch run ...`), in
process on the tiny config with `--device cpu` (the kernels' plain
versions). Every run goes through `--verify` (full-slot decrypt check)."""

import re

import pytest

from homulator_tpu_torch import api, cli

CFG = "configs/tiny.cfg"


@pytest.mark.parametrize("op", ["hmult", "hsquare", "hrotate", "hadd", "hsub",
                                "padd", "pmult"])
def test_cli_verify(op, capsys):
    rc = cli.main(["run", CFG, op, "8", "4", "4", "--verify", "--iters", "1",
                   "--device", "cpu"])
    outp = capsys.readouterr().out
    assert rc == 0, outp
    assert "verify max-abs-err" in outp
    assert f"FHE-Op {op} latency" in outp


@pytest.mark.parametrize("op", ["hmult", "hrotate"])
def test_cli_fused_hpip_routing(op, capsys):
    """`--fused-hpip` reaches the fused HPIP route (api.USE_FUSED_HPIP)
    and still decrypt-verifies; the flag is restored after the run."""
    assert api.USE_FUSED_HPIP is False
    rc = cli.main(["run", CFG, op, "8", "4", "4", "--verify", "--iters", "1",
                   "--device", "cpu", "--fused-hpip"])
    outp = capsys.readouterr().out
    assert rc == 0, outp
    assert "keyswitch=fused-hpip" in outp
    assert "verify max-abs-err" in outp
    assert api.USE_FUSED_HPIP is False


def test_cli_fused_hpip_cfg_key(tmp_path, capsys):
    """The cfg key `fused_hpip = 1` selects the same route."""
    cfg = tmp_path / "fused.cfg"
    cfg.write_text(open(CFG).read() + "\nfused_hpip = 1\n")
    rc = cli.main(["run", str(cfg), "hrotate", "8", "4", "4", "--verify",
                   "--iters", "1", "--device", "cpu"])
    outp = capsys.readouterr().out
    assert rc == 0, outp
    assert "keyswitch=fused-hpip" in outp
    assert api.USE_FUSED_HPIP is False


@pytest.mark.parametrize("argv,item", [
    (["hmult", "8", "4", "4", "2", "--dispatch", "gspmd"], "A12"),
    (["hadd", "8", "4", "4", "2", "--dispatch", "coeff"], "A12"),
])
def test_cli_names_roadmap_item_of_unported(argv, item, capsys):
    """The GSPMD paths, once unported (exit 2 naming ROADMAP A12.4), run
    since A12.4 landed: forced `--dispatch gspmd` takes the limb
    dispatch, and an elementwise op at [cluster] > 1 ignores --dispatch
    and runs over the rows of the mesh; both bit-exact."""
    rc = cli.main(["run", CFG, *argv, "--device", "cpu", "--verify",
                   "--iters", "1"])
    outp, err = capsys.readouterr()
    assert rc == 0, outp + err
    assert f"ROADMAP {item}.4" not in err
    assert "bit-exact" in outp and "verify max-abs-err" in outp
    want = ("# dispatch=gspmd -> limb (" if argv[0] == "hmult"
            else "# dispatch=gspmd mesh=(2 rows) ThreadMesh")
    assert want in outp


def test_cli_unknown_op_gets_jax_message(capsys):
    rc = cli.main(["run", CFG, "hdiv", "8", "4", "4", "--device", "cpu"])
    assert rc == 1
    assert ("unknown op 'hdiv' (expected hmult|hadd|hrotate|pmult|padd"
            "|hsub|hsquare)") in capsys.readouterr().err


@pytest.mark.parametrize("op", ["hmult", "hrotate"])
def test_cli_coeff_dispatch_packed(op, tmp_path, capsys):
    """`--dispatch coeff` at 8 shards of N = 4096 (n1 = 64, c = 8: the
    lane-packed route, k = 16) exits 0, bit-exact, and reports the JAX
    CLI's bytes per shard (its ici_bytes_per_op at the default routing)."""
    from homulator_tpu.parallel.sharded import ici_bytes_per_op
    from homulator_tpu.params import get_params

    cfg = tmp_path / "n4096.cfg"
    cfg.write_text("N = 4096\ncluster = 1\n")
    rc = cli.main(["run", str(cfg), op, "4", "4", "2", "8", "--dispatch",
                   "coeff", "--device", "cpu", "--verify", "--iters", "1"])
    outp = capsys.readouterr().out
    assert rc == 0, outp
    p = get_params(n=4096, max_level=4, alpha=2)
    want = ici_bytes_per_op(p, 4, 8, op)
    assert f"ici_bytes_per_device={want} ntt=lane-packed k=16" in outp
    assert "bit-exact" in outp and "verify max-abs-err" in outp
    assert _stat(outp, "ICI_bytes_per_device") == want
    assert _stat(outp, "batchCount") == 4096 // 256


def _stat(outp, key):
    """The value of `key` in the CLI's stat table (Statistic.table)."""
    m = re.search(rf"^{key}\s+(\d+)$", outp, re.MULTILINE)
    assert m, f"{key} not in the stat table:\n{outp}"
    return int(m.group(1))


def test_cli_stat_table_keys(capsys):
    """The JAX CLI's stat keys: batchCount = N/256 on every run
    (homulator_tpu/cli.py:420); a single-device run has no
    ICI_bytes_per_device."""
    rc = cli.main(["run", CFG, "hadd", "8", "4", "4", "--iters", "1",
                   "--device", "cpu"])
    outp = capsys.readouterr().out
    assert rc == 0, outp
    assert _stat(outp, "batchCount") == 256 // 256
    assert "ICI_bytes_per_device" not in outp


@pytest.mark.parametrize("argv,msg", [
    (["hmult", "8", "4", "4", "--dispatch", "coeff"], "needs the [cluster]"),
    (["hmult", "8", "4", "4", "1", "--dispatch", "limb"],
     "needs the [cluster]"),
    (["hrotate", "8", "4", "4", "--dispatch", "hybrid"],
     "needs the [cluster]"),
    (["hmult", "8", "8", "4", "4", "--dispatch", "coeff"], "per-shard tiles"),
    (["hmult", "8", "8", "4", "2", "--dispatch", "hybrid"],
     "--dispatch hybrid needs an even cluster >= 4"),
    (["hrotate", "8", "8", "4", "3", "--dispatch", "hybrid"],
     "--dispatch hybrid needs an even cluster >= 4"),
])
def test_cli_usage_errors_exit_1(argv, msg, capsys):
    """Usage errors exit with 1, as the JAX CLI's SystemExit("...")
    (homulator_tpu/cli.py:101-104, 146-149); 2 stays "not ported yet"."""
    rc = cli.main(["run", CFG, *argv, "--device", "cpu"])
    assert rc == 1
    assert msg in capsys.readouterr().err


def _run_sharded(op, level, cluster, dispatch, capsys):
    """A --verify run of op at [cluster]; returns its stdout."""
    rc = cli.main(["run", CFG, op, "8", str(level), "4", str(cluster),
                   "--dispatch", dispatch, "--device", "cpu", "--verify",
                   "--iters", "1"])
    outp = capsys.readouterr().out
    assert rc == 0, outp
    assert "bit-exact" in outp and "verify max-abs-err" in outp
    return outp


@pytest.mark.parametrize("op", ["hmult", "hrotate"])
@pytest.mark.parametrize("cluster", [2, 4])
def test_cli_auto_takes_choose_axis(op, cluster, capsys):
    """The default --dispatch auto runs the axis dispatch_model.choose_axis
    names (no anchors: the one whose shards receive fewer bytes), says
    why, and reports that axis's bytes a shard."""
    from homulator_tpu_torch.parallel.dispatch_model import choose_axis
    from homulator_tpu_torch.parallel.limb_sharded import (
        ici_bytes_per_op_limb,
    )
    from homulator_tpu_torch.parallel.mesh import coeff_shard_ok
    from homulator_tpu_torch.parallel.sharded import ici_bytes_per_op
    from homulator_tpu_torch.params import get_params

    p = get_params(n=256, max_level=8, alpha=4)
    ok = coeff_shard_ok(p.ntt.n1, p.ntt.n2, cluster)
    axis = choose_axis(p, op, cluster, 4, coeff_ok=ok)[0]
    outp = _run_sharded(op, 4, cluster, "auto", capsys)
    assert f"# dispatch={axis} " in outp
    assert f"-> {axis}; picked by ICI volume (no model anchors)" in outp
    want = (ici_bytes_per_op_limb(p, 4, cluster, op) if axis == "limb"
            else ici_bytes_per_op(p, 4, cluster, op))
    assert _stat(outp, "ICI_bytes_per_device") == want


@pytest.mark.parametrize("op", ["hmult", "hrotate"])
@pytest.mark.parametrize("level", [4, 5], ids=["divisible", "padded"])
def test_cli_forced_limb(op, level, capsys):
    """--dispatch limb at 4 shards, level 4 (divides) and 5 (pad rows)."""
    outp = _run_sharded(op, level, 4, "limb", capsys)
    assert "# dispatch=limb mesh=(4 limb)" in outp
    assert "-> limb (forced)" in outp


@pytest.mark.parametrize("op", ["hmult", "hrotate"])
def test_cli_forced_hybrid(op, capsys):
    """--dispatch hybrid at [cluster] 4: 2 limb x 2 coeff, level 5."""
    from homulator_tpu_torch.parallel.limb_sharded import (
        ici_bytes_per_op_hybrid,
    )
    from homulator_tpu_torch.params import get_params

    outp = _run_sharded(op, 5, 4, "hybrid", capsys)
    assert "# dispatch=hybrid mesh=(2 limb, 2 coeff)" in outp
    p = get_params(n=256, max_level=8, alpha=4)
    # rotation by 1 is the identity block map at 2 coeff shards here
    assert _stat(outp, "ICI_bytes_per_device") == ici_bytes_per_op_hybrid(
        p, 5, 2, 2, op, route_identity=True)


@pytest.mark.parametrize("op", ["hadd", "hsub", "padd", "pmult", "hsquare"])
def test_cli_cluster_2_every_op(op, capsys):
    """Each op at [cluster] 2 with --verify: the elementwise ops over the
    rows of a 2-shard mesh (no bytes exchanged), hsquare on hmult's
    dispatch (auto); bit-exact against the single-device op."""
    rc = cli.main(["run", CFG, op, "8", "4", "4", "2", "--verify",
                   "--iters", "1", "--device", "cpu"])
    outp = capsys.readouterr().out
    assert rc == 0, outp
    assert "bit-exact" in outp and "verify max-abs-err" in outp
    assert "cost counters unavailable: sharded run" in outp
    if op == "hsquare":
        assert "ici/device: limb=" in outp
        assert _stat(outp, "ICI_bytes_per_device") > 0
    else:
        assert "# dispatch=gspmd mesh=(2 rows)" in outp
        assert _stat(outp, "ICI_bytes_per_device") == 0


def test_cli_cost_counter_keys(capsys):
    """A single-device run prints the JAX CLI's counters: HBM_bytes,
    MEM_arg_bytes, MEM_out_bytes and HBM_GBps_achieved; no MEM_temp_bytes
    on the CPU (the caching allocator's, on the card only) and no
    FLOPs_compiled (no compiler counts the op)."""
    rc = cli.main(["run", CFG, "hmult", "8", "4", "4", "--iters", "1",
                   "--device", "cpu"])
    outp = capsys.readouterr().out
    assert rc == 0, outp
    for key in ("HBM_bytes", "MEM_arg_bytes", "MEM_out_bytes",
                "HBM_GBps_achieved"):
        _stat(outp, key)
    assert _stat(outp, "HBM_bytes") > _stat(outp, "MEM_arg_bytes") > 0
    assert "MEM_temp_bytes" not in outp and "FLOPs_compiled" not in outp


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX engine and operands of the CLI's tiny run (8 4 4, seed 0)."""
    import numpy as np

    from homulator_tpu.api import CkksEngine
    from homulator_tpu.params import get_params

    eng = CkksEngine(get_params(256, 8, 4, 29), seed=0)
    eng.keygen()
    rng = np.random.default_rng(0)
    v1, v2 = rng.normal(size=128), rng.normal(size=128)
    scale = float(1 << 29)
    return (eng, eng.encrypt_complex(v1, 4, scale),
            eng.encrypt_complex(v2, 4, scale),
            eng.plaintext_complex(v2, 4, scale))


@pytest.mark.parametrize("op", ["hmult", "hsquare", "hrotate", "hadd",
                                "hsub", "padd", "pmult"])
def test_cli_mem_out_bytes_match_jax(op, jax_tiny, capsys):
    """MEM_out_bytes == the JAX op_cost_counters' at configs/tiny.cfg."""
    rc = cli.main(["run", CFG, op, "8", "4", "4", "--iters", "1",
                   "--device", "cpu"])
    outp = capsys.readouterr().out
    assert rc == 0, outp
    eng, ct1, ct2, pt2 = jax_tiny
    want = eng.op_cost_counters(op, ct1, ct2, pt2)["MEM_out_bytes"]
    assert _stat(outp, "MEM_out_bytes") == want


@pytest.mark.parametrize("op", ["hmult", "hrotate", "pmult"])
def test_op_cost_counters_repeat(op):
    """HBM_bytes and MEM_* are counts: two calls give the same numbers,
    and the engine's own op counters are left as they were."""
    import numpy as np

    from homulator_tpu_torch.api import CkksEngine, get_params

    eng = CkksEngine(get_params(256, 8, 4), seed=0, device="cpu")
    eng.keygen()
    rng = np.random.default_rng(0)
    ct1, ct2 = (eng.encrypt_complex(rng.normal(size=128), 4, 2.0**29)
                for _ in range(2))
    pt = eng.plaintext_complex(rng.normal(size=128), 4, 2.0**29)
    first = eng.op_cost_counters(op, ct1, ct2, pt)
    assert set(first) == {"HBM_bytes", "MEM_arg_bytes", "MEM_out_bytes"}
    assert first == eng.op_cost_counters(op, ct1, ct2, pt)
    assert not eng.stats.counters


def test_cli_profile_writes_trace(tmp_path, capsys):
    """--profile DIR: a torch.profiler Chrome trace of the timed runs."""
    import json

    out = tmp_path / "prof"
    rc = cli.main(["run", CFG, "hmult", "8", "4", "4", "--iters", "2",
                   "--device", "cpu", "--profile", str(out)])
    assert rc == 0
    assert f"# profiler trace written to {out}" in capsys.readouterr().out
    trace = json.loads((out / "homulator_tpu_torch_hmult.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mul" in names or "aten::mul_" in names


@pytest.mark.parametrize("platform,rc_want", [("cpu", 0), ("tpu", 1),
                                              ("gpu", 1)])
def test_cli_platform(platform, rc_want, capsys):
    """--platform names the device as JAX names its platforms: cpu runs
    (the JAX CLI tests' command lines), tpu is no platform of the port,
    and gpu contradicts the explicit --device cpu: usage errors, exit 1."""
    argv = ["run", CFG, "hadd", "8", "4", "4", "2", "--verify", "--iters",
            "1", "--platform", platform]
    if platform == "gpu":
        argv += ["--device", "cpu"]
    rc = cli.main(argv)
    outp, err = capsys.readouterr()
    assert rc == rc_want, outp + err
    if rc_want:
        assert f"--platform {platform}" in err
    else:
        assert "# device=cpu" in outp and "bit-exact" in outp


def test_cli_cache_dir(tmp_path, capsys):
    """--cache-dir DIR is where the kernels are built and loaded for the
    run (kernels.BUILD_DIR, so library_path under it); the default is
    restored after it."""
    from homulator_tpu_torch import kernels

    default = kernels.BUILD_DIR
    seen = []
    real = cli.run_op

    def spy(args):
        rc = real(args)
        seen.append(kernels.library_path())
        return rc

    cli.run_op = spy
    try:
        rc = cli.main(["run", CFG, "hadd", "8", "4", "4", "--iters", "1",
                       "--device", "cpu", "--cache-dir", str(tmp_path)])
    finally:
        cli.run_op = real
    assert rc == 0
    assert f"# kernel cache: {tmp_path}" in capsys.readouterr().out
    assert seen[0].startswith(str(tmp_path) + "/")
    assert kernels.BUILD_DIR == default
