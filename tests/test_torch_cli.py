"""CLI contract of the port (`python -m homulator_tpu_torch run ...`), in
process on the tiny config with `--device cpu` (the kernels' plain
versions). Every run goes through `--verify` (full-slot decrypt check)."""

import pytest

from homulator_tpu_torch import cli

CFG = "configs/tiny.cfg"


@pytest.mark.parametrize("op", ["hmult", "hsquare"])
def test_cli_verify(op, capsys):
    rc = cli.main(["run", CFG, op, "8", "4", "4", "--verify", "--iters", "1",
                   "--device", "cpu"])
    outp = capsys.readouterr().out
    assert rc == 0, outp
    assert "verify max-abs-err" in outp
    assert f"FHE-Op {op} latency" in outp


@pytest.mark.parametrize("argv,item", [
    (["hrotate", "8", "4", "4"], "A7"),
    (["hadd", "8", "4", "4"], "A8"),
    (["hmult", "8", "4", "4", "2"], "A12"),
])
def test_cli_names_roadmap_item_of_unported(argv, item, capsys):
    rc = cli.main(["run", CFG, *argv, "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 2
    assert f"ROADMAP {item}" in err
