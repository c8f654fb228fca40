"""The check's limits hold against what they must catch, at small sizes on
the CPU: the control (the reference in float64 products) and a run whose
timed path is broken underneath come out wrong."""

import time

import pytest
import torch

from portbench import control, witness
from portbench.harness import cell
from portbench.tests.tiny import MIXES, TINY

ROOT = cell.manifest.ROOT


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17, 2 ** 40 + 1])
def test_control_fails_the_limit(mix, seed):
    """The control in the program's place, through a run's own check."""
    name, mx = MIXES[mix]
    r = control.control_run(ROOT, name, seed, 0.2, "cpu", TINY, mx)
    assert r["correct"] is False
    assert r["checks"]["wrong_words"]["value"] > 0
    assert r["checks"]["outputs_checked"]["value"] >= 2


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_witness_runs_the_reference_on_two_devices(mix):
    name, mx = MIXES[mix]
    r = witness.witness(ROOT, name, 2 ** 31 + 9, ("cpu", "cpu"), TINY, mx)
    assert r["wrong_words"] == 0 and r["words"] > 0
    assert 0 <= r["entry"] < (mx.get("pool") or mx["pool_batches"])


def _unchanged(fn):
    # the step returns its state unchanged: the operand, not the answer
    return lambda *a: a[0]


def _half_left_out(fn):
    # half of the batch (hmult) or of the diagonal groups (matvec) left
    # out, the rest standing in for it
    def broken(*a):
        x = a[0]
        if x.ndim == 5:
            h = x.shape[0] // 2 or 1
            out = fn(x[:h], a[1][:h], *a[2:])
            return torch.cat([out, out])[:x.shape[0]]
        prep = a[1]
        g = prep.pt_groups.shape[0] // 2
        half = type(prep)(**{**prep.__dict__,
                             "pt_groups": prep.pt_groups[:g],
                             "giant_perms": prep.giant_perms[:g - 1],
                             "giant_keys": prep.giant_keys[:g - 1]})
        return fn(x, half)
    return broken


def _one_word_altered(fn):
    def broken(*a):
        out = fn(*a).clone()
        out.view(-1)[out.numel() // 3] ^= 1
        return out
    return broken


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out,
                                   _one_word_altered])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_broken_timed_path_is_not_correct(monkeypatch, mix, fault):
    from homulator_tpu_torch import api, workloads

    name, mx = MIXES[mix]
    mod, attr = ((api, "hmult_graph") if mix == "hmult"
                 else (workloads, "matvec_bsgs"))
    monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))
    r = cell.run_cell(ROOT, name, 11, 0.2, False, "cpu", time.perf_counter(),
                      config=TINY, mix=mx)
    assert r["correct"] is False
    assert r["checks"]["wrong_words"]["value"] > 0
    assert r["failed"] >= 1
