"""The port's hmult / hsquare end to end vs the JAX engine (jnp route, which
is bit-identical to its Pallas route) and vs the exact numpy engine
(`RefCkks.hmult`), bit for bit (tolerance 0), at the conftest's
small_params (n = 64, maxLevel 6, alpha 2: a partial digit at level 5).
The JAX engine's key and ciphertexts cross through `from_jax_state`."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from homulator_tpu_torch.api import CkksEngine
from homulator_tpu_torch.context import Ciphertext, DeviceContext, from_jax_state

SCALE = 2.0**29
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def engines(small_engine):
    """(JAX engine, port engine on the CPU with the same seed)."""
    eng = CkksEngine(small_engine.params, seed=7, device="cpu")
    eng.keygen()
    return small_engine, eng


def _pair(jeng, eng, level, seed):
    """Two JAX ciphertexts of random slots and their port copies."""
    rng = np.random.default_rng(seed)
    slots = jeng.params.n // 2
    v = [rng.normal(size=slots) for _ in range(2)]
    jct = [jeng.encrypt_complex(x, level, SCALE) for x in v]
    st = from_jax_state({str(i): np.asarray(c.data)
                         for i, c in enumerate(jct)}, eng.dc)
    tct = [Ciphertext(st[str(i)], level, SCALE) for i in range(2)]
    return v, jct, tct


def _u32(t):
    return t.numpy().view(np.uint32)


def test_keygen_matches_jax_key(engines):
    jeng, eng = engines
    key = from_jax_state({"k": np.asarray(jeng.relin_key)}, eng.dc)["k"]
    assert key.dtype == torch.int32
    assert torch.equal(key, eng.relin_key)


@pytest.mark.parametrize("level", [6, 5])
def test_hmult_matches_jax_and_ref(engines, level):
    jeng, eng = engines
    _, (ja, jb), (a, b) = _pair(jeng, eng, level, seed=level)
    out = eng.hmult(a, b)
    assert out.level == level - 1
    assert np.array_equal(_u32(out.data), np.asarray(jeng.hmult(ja, jb).data))
    ref = eng.ref.hmult(eng.to_ref(a), eng.to_ref(b))
    assert np.array_equal(eng.dc.download(out.data), ref.data)


@pytest.mark.parametrize("level", [6, 5])
def test_hsquare_matches_jax_and_ref(engines, level):
    jeng, eng = engines
    _, (ja, _), (a, _) = _pair(jeng, eng, level, seed=10 + level)
    out = eng.hsquare(a)
    assert np.array_equal(_u32(out.data), np.asarray(jeng.hsquare(ja).data))
    ref = eng.ref.hmult(eng.to_ref(a), eng.to_ref(a))
    assert np.array_equal(eng.dc.download(out.data), ref.data)


def test_full_slot_decrypt(engines):
    """Every slot of the port's own encrypt -> hmult -> hsquare chain."""
    _, eng = engines
    rng = np.random.default_rng(3)
    slots = eng.params.n // 2
    v1, v2 = rng.normal(size=slots), rng.normal(size=slots)
    a = eng.encrypt_complex(v1, 6, SCALE)
    b = eng.encrypt_complex(v2, 6, SCALE)
    prod = eng.hmult(a, b)
    assert np.max(np.abs(eng.decrypt_complex(prod) - v1 * v2)) < 1e-2
    sq = eng.hsquare(prod)
    assert sq.level == 4
    assert np.max(np.abs(eng.decrypt_complex(sq) - (v1 * v2) ** 2)) < 1e-2
    assert eng.stats.counters["op/hmult"] >= 1


def test_integer_coefficients_roundtrip(engines):
    """encrypt_ints / decrypt_bigint: a constant 7 squares to 49."""
    _, eng = engines
    m = np.zeros(eng.params.n, dtype=np.int64)
    m[0] = int(7 * SCALE)
    ct = eng.encrypt_ints(m, 6, SCALE)
    got = eng.decrypt_bigint(ct, count=4)
    assert abs(got[0] - m[0]) < 100 and all(abs(v) < 100 for v in got[1:])
    sq = eng.hmult(ct, ct)
    assert abs(eng.decrypt_bigint(sq, count=1)[0] / sq.scale - 49) < 1e-3


def test_engine_rejects_bad_operands(engines):
    _, eng = engines
    ct = eng.encrypt_complex(np.zeros(eng.params.n // 2), 1, SCALE)
    with pytest.raises(ValueError, match="level >= 2"):
        eng.hmult(ct, ct)
    fresh = CkksEngine(eng.params, seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="keygen"):
        fresh.hsquare(eng.encrypt_complex(np.zeros(eng.params.n // 2), 3,
                                          SCALE))


def test_cuda_device_is_explicit(small_params):
    """No silent CPU fallback: asking for CUDA without a CUDA device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceContext(small_params, device="cuda")


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port (its ops and
    parallel packages, serialize, linalg, benchlib, the native host core's
    binding, the workloads, the anatomy and peak kernels' wrappers
    included), chip_smoke, the port's scripts (scripts/*_torch.py: the
    roofline, the three NTT anatomy scripts, B4's bench and the two
    workload programs among them) and its examples (examples/*_torch.py),
    takes get_params from the port, runs a tiny hmult, hrotate,
    fused-route hmult, 2-shard coefficient-sharded and limb-sharded
    hmult, graph-route
    hmult, the elementwise ops, a serialize round trip, a linalg dot and
    a workloads BSGS matvec, and has loaded neither jax nor any module of
    the JAX package homulator_tpu."""
    code = (
        "import pkgutil, sys\n"
        "import numpy as np\n"
        "import homulator_tpu_torch, homulator_tpu_torch.ops, chip_smoke\n"
        "import homulator_tpu_torch.parallel\n"
        "for pkg in (homulator_tpu_torch, homulator_tpu_torch.ops,\n"
        "            homulator_tpu_torch.parallel):\n"
        "    for m in pkgutil.iter_modules(pkg.__path__):\n"
        "        if m.name != '__main__':  # __main__ runs the CLI\n"
        "            __import__(pkg.__name__ + '.' + m.name)\n"
        "from homulator_tpu_torch import api\n"
        "from homulator_tpu_torch.api import CkksEngine, get_params\n"
        "e = CkksEngine(get_params(n=64, max_level=3, alpha=2), seed=1,"
        " device='cpu')\n"
        "e.keygen()\n"
        "a = e.encrypt_complex(np.ones(32), 3, 2.0**29)\n"
        "assert e.hmult(a, a).level == 2\n"
        "assert e.hrotate(a, 1).level == 3\n"
        "api.USE_FUSED_HPIP = True\n"
        "assert e.hmult(a, a).level == 2\n"
        "from homulator_tpu_torch.parallel import comm, sharded\n"
        "f = sharded.make_shardmap_hmult(e.dc, 3, comm.ThreadMesh(2, 'cpu'))\n"
        "s = sharded.shard_cols\n"
        "out = sharded.gather_cols(f(s(a.data, 2), s(a.data, 2),"
        " s(e.relin_key, 2)))\n"
        "assert (out == e.hmult(a, a).data).all()\n"
        "from homulator_tpu_torch.parallel import limb_sharded as ls\n"
        "f = ls.make_limb_hmult(e.dc, 3, comm.ThreadMesh(2, 'cpu',"
        " names=('limb',)))\n"
        "out = ls.gather_rows(f(ls.shard_rows(a.data, 3, 2),"
        " ls.shard_rows(a.data, 3, 2), ls.limb_key(e.relin_key, e.params,"
        " 3, 2)), 2)\n"
        "assert (out[:, :2] == e.hmult(a, a).data).all()\n"
        "g = CkksEngine(e.params, seed=1, device='cpu', ntt_mode='jnp')\n"
        "g.relin_key = e.relin_key\n"
        "assert (g.hmult(a, a).data == e.hmult(a, a).data).all()\n"
        "pt = e.plaintext_complex(np.ones(32), 3, 2.0**29)\n"
        "b = e.cadd(e.cmult(e.padd(e.hsub(e.hadd(a, a), a), pt), 0.5), 1.0)\n"
        "assert e.rescale(e.mod_drop(b)).level == 1\n"
        "assert e.pmult(a, pt).level == 3\n"
        "import os, tempfile\n"
        "from homulator_tpu_torch import linalg, serialize\n"
        "path = os.path.join(tempfile.mkdtemp(), 'ct.npz')\n"
        "serialize.save_ciphertext(path, a, e.params)\n"
        "assert (serialize.load_ciphertext(path, e.dc).data == a.data).all()\n"
        "assert linalg.dot(e, a, np.ones(32)).level == 2\n"
        "from homulator_tpu_torch import workloads\n"
        "prep = workloads.matvec_prep(e, np.eye(4), 3, 2.0**29, 2)\n"
        "assert workloads.matvec_bsgs(a.data, prep).shape == a.data.shape\n"
        "import glob, importlib.util\n"
        "scripts = sorted(glob.glob('scripts/*_torch.py'))\n"
        "examples = sorted(glob.glob('examples/*_torch.py'))\n"
        "assert len(examples) == 3, examples\n"
        "for path in scripts + examples:\n"
        "    spec = importlib.util.spec_from_file_location("
        "os.path.basename(path)[:-3], path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "for name in ('roofline_torch', 'microbench_ntt_torch',"
        " 'microbench_ntt2_torch', 'bench_ntt_variants_torch',"
        " 'bench_hpip_torch', 'bench_phase_torch', 'bench_workload_torch',"
        " 'bench_logreg_torch'):\n"
        "    assert f'scripts/{name}.py' in scripts, name\n"
        "bad = sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'homulator_tpu'))\n"
        "assert not bad, bad\n"
        "for m in ('ops.hpip', 'ops.bconv', 'ops.rescale', 'serialize',"
        " 'linalg', 'benchlib', 'ops.anatomy', 'ops.peaks', 'native',"
        " 'workloads'):\n"
        "    assert 'homulator_tpu_torch.' + m in sys.modules, m\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
