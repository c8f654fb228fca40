"""Entry points of the port's dry run: the counterpart of the JAX
package's `__graft_entry__.py`.

  entry()             (fn, example_args): the single-device hmult graph
                      (tensor product, key switch, rescale) at n = 4096,
                      max_level 8, alpha 4, level 6, seed 3, as the JAX
                      `entry()` builds it.
  dryrun_multichip(n) every multi-device dispatch of the port on n shards
                      at tiny shapes (n = 256, max_level 8, alpha 4,
                      level 8), each result held bit for bit against the
                      single-device graph: the coefficient hmult with a
                      data axis and hrotate (step 3), the limb and hybrid
                      hmult and hrotate, make_sharded_hmult on a (data,
                      limb, coeff) mesh, and the elementwise ops over rows
                      or n2 (hadd, hsub, padd, pmult).

`mesh="thread"` runs the shards as a ThreadMesh in this process;
`mesh="dist"` is the body of one process of a torch.distributed world of
n processes (gloo on the CPU, NCCL with a card per process) that the
caller starts, each on a DistMesh.grid, and checks that process's slices.
Both run on the card unless `device="cpu"` asks for the kernels' plain
versions.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

SCALE = 2.0**29
LEVEL = 8
STEP = 3


def _engine(n: int, max_level: int, alpha: int, device):
    from .api import CkksEngine, get_params

    eng = CkksEngine(get_params(n=n, max_level=max_level, alpha=alpha),
                     seed=3, device=device)
    eng.keygen()
    return eng


def entry(device="cuda"):
    """Returns (fn, example_args): fn(a, b) is hmult_graph over the
    engine's relinearisation key and level-6 tables, the args two
    encryptions of one random integer message (numpy seed 0)."""
    from .api import hmult_graph

    eng = _engine(4096, 8, 4, device)
    level = 6
    kt = eng.dc.keyswitch_tables(level)
    evk = eng.relin_key
    p = eng.params
    rng = np.random.default_rng(0)
    m = np.zeros(p.n, dtype=np.int64)
    m[: p.n // 2] = rng.integers(-1000, 1000, size=p.n // 2)
    ct1 = eng.encrypt_ints(m, level, SCALE)
    ct2 = eng.encrypt_ints(m, level, SCALE)

    def fn(a_data: torch.Tensor, b_data: torch.Tensor) -> torch.Tensor:
        return hmult_graph(a_data, b_data, evk, kt)

    return fn, (ct1.data, ct2.data)


def _batch(eng, count: int, rng) -> torch.Tensor:
    """count encryptions at LEVEL of one random constant each, stacked."""
    cts = []
    for _ in range(count):
        m = np.zeros(eng.params.n, dtype=np.int64)
        m[0] = int(rng.normal() * SCALE)
        cts.append(eng.encrypt_ints(m, LEVEL, SCALE).data)
    return torch.stack(cts)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x [..., r, n2, n1] with zero rows appended up to `rows`."""
    pad = rows - x.shape[-3]
    return torch.cat([x, x.new_zeros(x.shape[:-3] + (pad,)
                                     + tuple(x.shape[-2:]))], dim=-3)


def dryrun_multichip(n_devices: int, *, device="cuda",
                     mesh: str = "thread") -> List[str]:
    """Run every ported dispatch over n_devices shards and hold each
    result bit for bit against the single-device graph (module
    docstring); raises AssertionError on the first that differs. Returns
    the names of the paths checked."""
    from .api import (
        hadd_graph, hmult_graph, hrotate_graph, hsub_graph, padd_graph,
        pmult_graph,
    )
    from .parallel import limb_sharded as ls
    from .parallel import sharded as sh
    from .parallel.comm import DistMesh, ThreadMesh
    from .parallel.mesh import coeff_shard_ok

    if mesh not in ("thread", "dist"):
        raise ValueError(f"mesh {mesh!r}: 'thread' or 'dist'")
    dist = mesh == "dist"
    if dist:
        import torch.distributed as tdist

        if tdist.get_world_size() != n_devices:
            raise ValueError(f"world of {tdist.get_world_size()} processes "
                             f"for a dry run on {n_devices}")
    n = n_devices

    def make(shape, names, data=1):
        if dist:
            return DistMesh.grid(shape, names, data=data)
        return ThreadMesh(shape, device, data=data, names=names)

    checked: List[str] = []

    def check(name: str, m, got: Sequence[torch.Tensor],
              want: Sequence[torch.Tensor]) -> None:
        """got: the mesh's results (all shards, or this process's); want:
        every shard's expected slice in Comm.index order."""
        idx = [m.index] if dist else range(len(want))
        if len(got) != len(idx) or not all(
                torch.equal(g, want[i]) for g, i in zip(got, idx)):
            raise AssertionError(f"{name} on {n} shards != single-device")
        checked.append(name)

    eng = _engine(256, 8, 4, device)
    eng.gen_rotation_key(STEP)
    p, dc = eng.params, eng.dc
    t = p.ntt
    kt = dc.keyswitch_tables(LEVEL)
    rng = np.random.default_rng(1)
    g = p.galois_elt(STEP)
    rkey = eng.rot_keys[STEP]

    def one(a, b):
        return hmult_graph(a, b, eng.relin_key, kt)

    def rot(a):
        return hrotate_graph(a, dc.automorph_perm(g), rkey, kt)

    # coefficient dispatch: the coeff extent folded to a tile the plain
    # and the per-limb phase kernels take (>= 4 columns), the rest of the
    # shards data rows (__graft_entry__.py:106-113)
    ns_c = n
    while ns_c > 1 and not coeff_shard_ok(t.n1, t.n2, ns_c, min_tile=4):
        ns_c //= 2
    d = n // ns_c
    B = 2 * d
    a, b = _batch(eng, B, rng), _batch(eng, B, rng)
    want = torch.stack([one(x, y) for x, y in zip(a, b)])
    m = make(ns_c, ("coeff",), data=d)
    f = sh.make_shardmap_hmult(dc, LEVEL, m, data_axis="data")
    check("coeff hmult (data x coeff)", m,
          f(sh.shard_batch(a, d, ns_c), sh.shard_batch(b, d, ns_c),
            sh.shard_cols(eng.relin_key, ns_c)),
          sh.shard_batch(want, d, ns_c))
    rwant = rot(a[0])
    if dist and ns_c < n:  # the first ns_c processes, the rest stand by
        import torch.distributed as tdist

        group = tdist.new_group(list(range(ns_c)))
        mr = DistMesh(group) if tdist.get_rank() < ns_c else None
    else:
        mr = make(ns_c, ("coeff",))
    if mr is not None:
        fr = sh.make_shardmap_hrotate(dc, LEVEL, mr)
        check("coeff hrotate", mr,
              fr(sh.shard_cols(a[0], ns_c), dc.automorph_shard_route(g, ns_c),
                 sh.shard_cols(rkey, ns_c)),
              sh.shard_cols(rwant, ns_c))

    # limb dispatch on all n shards; hybrid (n/2 limb x 2 coeff)
    hwant = _pad_rows(want[0], LEVEL)
    for ns_l, ns_c2 in ((n, 1),) + (((n // 2, 2),)
                                    if n >= 4 and n % 2 == 0 else ()):
        hybrid = ns_c2 > 1
        kind = "hybrid" if hybrid else "limb"
        m = (make((ns_l, ns_c2), ("limb", "coeff")) if hybrid
             else make(ns_l, ("limb",)))
        lay = lambda x: ls.shard_rows(x, LEVEL, ns_l, ns_c2)  # noqa: E731
        fm = (ls.make_hybrid_hmult if hybrid else ls.make_limb_hmult)(
            dc, LEVEL, m)
        check(f"{kind} hmult", m,
              fm(lay(a[0]), lay(b[0]),
                 ls.limb_key(eng.relin_key, p, LEVEL, ns_l, ns_c2)),
              lay(hwant))
        rk = ls.limb_key(rkey, p, LEVEL, ns_l, ns_c2)
        if hybrid:
            out = ls.make_hybrid_hrotate(dc, LEVEL, m)(
                lay(a[0]), dc.automorph_shard_route(g, ns_c2), rk)
        else:
            out = ls.make_limb_hrotate(dc, LEVEL, m)(
                lay(a[0]), dc.automorph_perm(g), rk)
        check(f"{kind} hrotate", m, out, lay(rwant))

    # make_sharded_hmult on (data, limb, coeff), __graft_entry__.py:225-230
    d = 2 if n % 2 == 0 else 1
    rest = n // d
    ns_c = 2 if rest % 2 == 0 and rest >= 4 else 1
    ns_l = rest // ns_c
    B = 2 * d
    a, b = _batch(eng, B, rng), _batch(eng, B, rng)
    want = torch.stack([one(x, y) for x, y in zip(a, b)])
    m = make((ns_l, ns_c), ("limb", "coeff"), data=d)
    got = sh.make_sharded_hmult(dc, LEVEL, m)(a, b, eng.relin_key)
    name = f"make_sharded_hmult ({d}, {ns_l}, {ns_c})"
    if dist:
        check(name, m, got, ls.shard_rows(_pad_rows(want, LEVEL), LEVEL,
                                          ns_l, ns_c, data=d))
    else:
        check(name, m, [got], [want])

    # the elementwise ops over rows (or n2), as the JAX CLI's GSPMD layout
    pt = eng.plaintext_ints(np.arange(p.n) % 97, LEVEL, SCALE)
    q = dc.q_level(LEVEL)
    axis = sh.elementwise_axis(LEVEL, n)
    m = make(n, ("rows",))
    cut = lambda x: sh.shard_elementwise(x, axis, n)  # noqa: E731
    for op, graph, other in (("hadd", hadd_graph, b[0]),
                             ("hsub", hsub_graph, b[0]),
                             ("padd", padd_graph, pt.data),
                             ("pmult", pmult_graph, pt.data)):
        f = sh.make_sharded_elementwise(dc, op, LEVEL, m)
        check(f"{op} over {'rows' if axis == -3 else 'n2'}", m,
              f(cut(a[0]), cut(other)), cut(graph(a[0], other, q)))
        if any(m.recv_bytes) if not dist else m.total_recv_bytes:
            raise AssertionError(f"{op}: a shard received bytes")
    return checked
