"""CLI contract of the port (`python -m homulator_tpu_torch run ...`), in
process on the tiny config with `--device cpu` (the kernels' plain
versions). Every run goes through `--verify` (full-slot decrypt check)."""

import pytest

from homulator_tpu_torch import api, cli

CFG = "configs/tiny.cfg"


@pytest.mark.parametrize("op", ["hmult", "hsquare", "hrotate"])
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
    (["padd", "8", "4", "4"], "A8"),
    (["hadd", "8", "4", "4"], "A8"),
    (["hmult", "8", "4", "4", "2"], "A12"),
])
def test_cli_names_roadmap_item_of_unported(argv, item, capsys):
    rc = cli.main(["run", CFG, *argv, "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 2
    assert f"ROADMAP {item}" in err
