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
    (["hmult", "8", "4", "4", "2"], "A12"),
    (["hadd", "8", "4", "4", "2", "--dispatch", "coeff"], "A12"),
])
def test_cli_names_roadmap_item_of_unported(argv, item, capsys):
    rc = cli.main(["run", CFG, *argv, "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 2
    assert f"ROADMAP {item}" in err


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
    assert f"ici_bytes_per_shard={want} ntt=lane-packed k=16" in outp
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
])
def test_cli_usage_errors_exit_1(argv, msg, capsys):
    """Usage errors exit with 1, as the JAX CLI's SystemExit("...")
    (homulator_tpu/cli.py:101-104, 146-149); 2 stays "not ported yet"."""
    rc = cli.main(["run", CFG, *argv, "--device", "cpu"])
    assert rc == 1
    assert msg in capsys.readouterr().err
