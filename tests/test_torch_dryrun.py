"""The port's dry run (homulator_tpu_torch/dryrun.py) on the CPU (the
kernels' plain versions), bit for bit (tolerance 0):

  * entry() against the JAX `__graft_entry__.entry()`: the same example
    ciphertexts (the host copies give the same keys and encryptions) and
    the same hmult output at n = 4096, level 6;
  * dryrun_multichip(8) on a ThreadMesh: every ported dispatch against
    the single-device graph;
  * dryrun_multichip(4, mesh="dist") in 4 CPU processes (gloo), each a
    DistMesh shard checking its own slices.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np

from homulator_tpu_torch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PATHS_8 = ["coeff hmult (data x coeff)", "coeff hrotate", "limb hmult",
           "limb hrotate", "hybrid hmult", "hybrid hrotate",
           "make_sharded_hmult (2, 2, 2)", "hadd over rows",
           "hsub over rows", "padd over rows", "pmult over rows"]


def test_entry_matches_jax_entry():
    sys.path.insert(0, ROOT)
    import __graft_entry__

    jfn, jargs = __graft_entry__.entry()
    fn, args = dryrun.entry(device="cpu")
    for ja, a in zip(jargs, args):
        assert np.array_equal(np.asarray(ja), a.numpy().view(np.uint32))
    want = np.asarray(jax.jit(jfn)(*jargs))
    got = fn(*args)
    assert got.shape == want.shape == (2, 5, 64, 64)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_dryrun_thread_mesh_8():
    assert dryrun.dryrun_multichip(8, device="cpu") == PATHS_8


_DIST_WORKER = r"""
import sys
import torch.distributed as dist
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)
from homulator_tpu_torch.dryrun import dryrun_multichip
print("PATHS", dryrun_multichip(4, device="cpu", mesh="dist"))
dist.destroy_process_group()
"""


def test_dryrun_dist_mesh_gloo_four_processes():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIST_WORKER, str(r), str(port)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    want = ["coeff hmult (data x coeff)", "coeff hrotate", "limb hmult",
            "limb hrotate", "hybrid hmult", "hybrid hrotate",
            "make_sharded_hmult (2, 2, 1)", "hadd over rows",
            "hsub over rows", "padd over rows", "pmult over rows"]
    for log in logs:
        assert f"PATHS {want}" in log, log
