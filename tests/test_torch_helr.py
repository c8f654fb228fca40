"""HELR (encrypted logistic-regression training, one NAG iteration) and the
batched rotation and squaring it runs on, at small parameters on the CPU:

- `api.hrotate_graph` and `api.hsquare_graph` on a batch [B, 2, level, ...]
  equal to one op at a time, word for word, on the piecewise and the
  fused route; the graph route refuses a batch;
- `workloads.helr_iteration` equal word for word to the plain reference
  `portbench/reference/logistic.helr_iteration` (one whole RefCkks op at a
  time) on 3 blocks of 8 rows x 16 features, and its decryption within a
  stated tolerance of the float64 step `helr_float`;
- `workloads.logreg_sigmoid3` equal to the reference's;
- the new reference and driver files import neither JAX nor, outside the
  driver's program, the port.

A card-marked case repeats the batch check at set B on the card (run with
`python -m pytest --noconftest -m card tests/test_torch_helr.py`).
"""

import ast
import os

import numpy as np
import pytest
import torch

from homulator_tpu_torch import api, workloads
from homulator_tpu_torch.api import CkksEngine, get_params
from homulator_tpu_torch.context import Ciphertext
from portbench.reference import logistic as ref_logistic
from portbench.reference.ckks import RefCkks
from portbench.reference.params import get_params as ref_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# three digits at level 11 (4, 4, 3 primes); HELR uses 6 levels
N, MAX_LEVEL, ALPHA, LEVEL = 256, 12, 4, 11
SCALE = 2.0 ** 29
ROWS, FEATURES, BLOCKS, INPUTS = 8, 16, 3, 13
GAMMA, ETA = 10 / 3, -0.28175352512532087
SEED = 23


@pytest.fixture(scope="module")
def eng():
    e = CkksEngine(get_params(N, MAX_LEVEL, ALPHA, 29), SEED, device="cpu")
    e.keygen()
    e.gen_rotation_key(5)
    return e


def _cts(eng, count, level=LEVEL):
    rng = np.random.default_rng(count)
    return [eng.encrypt_complex(rng.normal(size=eng.params.n // 2), level,
                                SCALE).data
            for _ in range(count)]


@pytest.fixture
def route(request):
    api.USE_FUSED_HPIP = request.param == "fused"
    yield request.param
    api.USE_FUSED_HPIP = False


@pytest.mark.parametrize("route", ["pieces", "fused"], indirect=True)
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_batched_rotation_and_square_equal_one_at_a_time(eng, route, batch):
    cts = _cts(eng, batch)
    a = torch.stack(cts)
    kt = eng.dc.keyswitch_tables(LEVEL)
    perm = eng.dc.automorph_perm(eng.params.galois_elt(5))
    key = eng.rot_keys[5]
    rot = api.hrotate_graph(a, perm, key, kt)
    sq = api.hsquare_graph(a, eng.relin_key, kt)
    assert rot.shape == a.shape and rot.dtype == torch.int32
    assert sq.shape == (batch, 2, LEVEL - 1) + a.shape[-2:]
    assert torch.equal(rot, torch.stack(
        [api.hrotate_graph(c, perm, key, kt) for c in cts]))
    assert torch.equal(sq, torch.stack(
        [api.hsquare_graph(c, eng.relin_key, kt) for c in cts]))


def test_graph_route_refuses_a_batched_rotation():
    e = CkksEngine(get_params(N, MAX_LEVEL, ALPHA, 29), SEED, device="cpu",
                   ntt_mode="jnp")
    e.keygen()
    e.gen_rotation_key(1)
    a = torch.stack(_cts(e, 2))
    with pytest.raises(ValueError, match="one ciphertext a call"):
        api.hrotate_graph(a, e.dc.automorph_perm(e.params.galois_elt(1)),
                          e.rot_keys[1], e.dc.keyswitch_tables(LEVEL))


def _helr_data():
    """z_i = y_i (1, x_i) zero-padded to FEATURES, beta and v."""
    rng = np.random.default_rng(5)
    n = ROWS * BLOCKS
    y = rng.choice([-1.0, 1.0], size=n)
    z = np.zeros((n, FEATURES))
    z[:, 0] = y
    z[:, 1:INPUTS + 1] = y[:, None] * rng.uniform(-1, 1, size=(n, INPUTS))
    w = np.zeros((2, FEATURES))
    w[:, :INPUTS + 1] = rng.normal(0, 0.05, size=(2, INPUTS + 1))
    return z, w[0], w[1]


def _blocks(z):
    return [z[k * ROWS:(k + 1) * ROWS].reshape(-1) for k in range(BLOCKS)]


@pytest.fixture(scope="module")
def helr():
    """The port's and the reference's iteration from one seed: the same
    keys and encryptions (the same order of draws)."""
    z, beta, v = _helr_data()
    e = CkksEngine(get_params(N, MAX_LEVEL, ALPHA, 29), SEED, device="cpu")
    e.keygen()
    prep = workloads.helr_prep(e, LEVEL, SCALE, ROWS, FEATURES, BLOCKS,
                               GAMMA, ETA)

    def enc(x):
        return e.encrypt_complex(x, LEVEL, SCALE).data

    cb, cv = enc(np.tile(beta, ROWS)), enc(np.tile(v, ROWS))
    Z = torch.stack([enc(b) for b in _blocks(z)])
    out = workloads.helr_iteration(Z, cb, cv, prep)

    ref = RefCkks(ref_params(N, MAX_LEVEL, ALPHA, 29), SEED)
    ref.keygen()
    rprep = ref_logistic.helr_prep(ref, LEVEL, SCALE, ROWS, FEATURES, BLOCKS,
                                   GAMMA, ETA)

    def renc(x):
        return ref.encrypt(ref.encode_complex(x, LEVEL, SCALE), LEVEL)

    rb, rv = renc(np.tile(beta, ROWS)), renc(np.tile(v, ROWS))
    want = ref_logistic.helr_iteration(ref, [renc(b) for b in _blocks(z)],
                                       rb, rv, rprep)
    return e, prep, out, want, (z, beta, v)


def test_helr_iteration_equals_the_reference(helr):
    _, prep, out, want, _ = helr
    assert out.shape == (2, 2, prep.out_level, 16, 16)
    assert out.dtype == torch.int32
    for got, w in zip(out, want):
        assert torch.equal(got.reshape(2, prep.out_level, -1).long(), w)


def test_helr_decrypts_to_the_float_step(helr):
    """beta' and v' decrypt to helr_float's within 1e-4 in every slot (each
    row holds the weights). The noise budget: t and t^3 reach scales near
    2^27 and 2^21, so their slots carry errors near 2^-22 and 2^-16
    (key-switch noise over the scale); through the sigmoid (|c3| 3 t^2 <
    0.1), the sum over 24 samples and gamma / 24 that is below 1e-5. The
    largest error read is near 1.2e-6."""
    e, prep, out, _, (z, beta, v) = helr
    b1, v1 = ref_logistic.helr_float(z, beta, v, GAMMA, ETA)
    for got, want in zip(out, (b1, v1)):
        dec = e.decrypt_complex(Ciphertext(got, prep.out_level, prep.s_out))
        rows = dec.reshape(ROWS, FEATURES)
        assert np.abs(rows.imag).max() < 1e-4
        assert np.abs(rows.real - want).max() < 1e-4


def test_helr_prep_refuses_a_layout_off_the_slots(eng):
    with pytest.raises(ValueError, match="rows x"):
        workloads.helr_prep(eng, LEVEL, SCALE, 4, FEATURES, 1, GAMMA, ETA)


def test_logreg_sigmoid3_equals_the_reference():
    level = 8
    rng = np.random.default_rng(3)
    slots = N // 2
    w = rng.normal(size=slots) / np.sqrt(slots)
    x = rng.normal(size=slots)
    e = CkksEngine(get_params(N, 10, 5, 29), SEED, device="cpu")
    e.keygen()
    for s in workloads.logreg_steps(slots):
        e.gen_rotation_key(s)
    prep = workloads.logreg_prep(e, w, 0.3, level, SCALE)
    got = workloads.logreg_sigmoid3(
        e.encrypt_complex(x, level, SCALE).data, prep)
    ref = RefCkks(ref_params(N, 10, 5, 29), SEED)
    ref.keygen()
    rprep = ref_logistic.logreg_prep(ref, w, 0.3, level, SCALE)
    want = ref_logistic.logreg_sigmoid3(
        ref, ref.encrypt(ref.encode_complex(x, level, SCALE), level), rprep)
    assert torch.equal(got.reshape(2, level - 3, -1).long(), want)


def _imports(path):
    """(module, inside a function) of every import in the file."""
    tree = ast.parse(open(path).read(), path)
    inner = {id(n) for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
             for n in ast.walk(f)}
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name, id(node) in inner) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.module, id(node) in inner))
    return out


@pytest.mark.parametrize("rel", [
    "portbench/reference/logistic.py", "portbench/counts/logistic.py",
    "portbench/drivers/helr_iter.py", "portbench/drivers/logreg_sigmoid3.py",
    "portbench/metrics/rotate_ms_per_req.py",
    "portbench/metrics/automorph_ms_per_req.py"])
def test_new_benchmark_files_import_no_jax(rel):
    """No import of JAX or the JAX package anywhere; the port only inside
    a driver's program(), never in the reference or the counts."""
    for mod, in_function in _imports(os.path.join(ROOT, rel)):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "homulator_tpu"), (rel, mod)
        if top == "homulator_tpu_torch":
            assert in_function and "drivers" in rel, (rel, mod)


@pytest.mark.card
def test_batched_rotation_and_square_on_the_card():
    """Set B at level 34 on the card: a batch of 8 rotations and of 8
    squares, each one program, equal word for word to one op at a time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels run only there")
    e = workloads.native_engine(get_params(65536, 45, 15, 29), SEED, "cuda")
    e.keygen()
    e.gen_rotation_key(-3)
    cts = _cts(e, 8, 34)
    a = torch.stack(cts)
    kt = e.dc.keyswitch_tables(34)
    perm = e.dc.automorph_perm(e.params.galois_elt(-3))
    rot = api.hrotate_graph(a, perm, e.rot_keys[-3], kt)
    sq = api.hsquare_graph(a, e.relin_key, kt)
    assert torch.equal(rot, torch.stack(
        [api.hrotate_graph(c, perm, e.rot_keys[-3], kt) for c in cts]))
    assert torch.equal(sq, torch.stack(
        [api.hsquare_graph(c, e.relin_key, kt) for c in cts]))
