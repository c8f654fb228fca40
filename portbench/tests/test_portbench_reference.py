"""The plain reference agrees with the port at small sizes on the CPU: its
keys and encryptions from a seed with the port's host engine, and every
sampled answer of a whole run with the port's plain paths."""

import time

import numpy as np
import pytest
import torch

from portbench.harness import cell
from portbench.reference import ckks
from portbench.reference.params import get_params as ref_params
from portbench.tests.tiny import MIXES, TINY

ROOT = cell.manifest.ROOT


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 99])
def test_run_matches_reference(mix, seed):
    name, mx = MIXES[mix]
    r = cell.run_cell(ROOT, name, seed, 0.3, False, "cpu",
                      time.perf_counter(), config=TINY, mix=mx)
    assert r["checks"]["wrong_words"]["value"] == 0
    assert r["checks"]["outputs_checked"]["value"] >= 2
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    e2e = {m["name"] for m in cell.manifest.metrics_of(
        cell.manifest.load(ROOT), "end_to_end", name)}
    # all but the memory peak, which only the card reads
    assert set(r["metrics"]) == e2e - {"device_mem_peak_GiB"}


def test_keys_and_encryption_replay_the_port():
    from homulator_tpu_torch.params import get_params
    from homulator_tpu_torch.refimpl import RefCkks

    c = TINY
    seed = 2 ** 33 + 5
    port = RefCkks(get_params(c["n"], c["max_level"], c["alpha"]), seed,
                   use_native=False)
    ref = ckks.RefCkks(ref_params(c["n"], c["max_level"], c["alpha"]), seed)
    port.keygen()
    ref.keygen()
    for d in range(len(ref.relin_key)):
        assert np.array_equal(port.relin_key.digits[d].astype(np.int64),
                              ref.relin_key[d].numpy())
    assert np.array_equal(port.gen_rotation_key(3).digits[1].astype(np.int64),
                          ref.gen_rotation_key(3)[1].numpy())
    v = np.random.default_rng(1).normal(size=c["n"] // 2)
    a = port.encrypt(port.encode_complex(v, 5, 2.0 ** 29))
    b = ref.encrypt(ref.encode_complex(v, 5, 2.0 ** 29), 5)
    assert np.array_equal(a.data.astype(np.int64), b.numpy())
    # the operations on the port's numpy engine
    a2 = port.encrypt(port.encode_complex(v[::-1].copy(), 5, 2.0 ** 29))
    b2 = ref.encrypt(ref.encode_complex(v[::-1].copy(), 5, 2.0 ** 29), 5)
    assert np.array_equal(port.hmult(a, a2).data.astype(np.int64),
                          ref.hmult(b, b2, 5).numpy())
    assert np.array_equal(port.hrotate(a, 3).data.astype(np.int64),
                          ref.hrotate(b, 3, 5).numpy())


def test_control_differs_from_exact():
    c = TINY
    p = ref_params(c["n"], c["max_level"], c["alpha"])
    x = torch.randint(0, 2 ** 29, (c["level"], c["n"]), dtype=torch.int64)
    exact = ckks.RefCkks(p, 1).ntt(x, np.arange(c["level"]))
    control = ckks.RefCkks(p, 1, exact=False).ntt(x, np.arange(c["level"]))
    assert (exact != control).float().mean() > 0.5
