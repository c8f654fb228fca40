"""Collectives of the sharded dispatches, and the meshes that run their
per-shard programs.

The JAX package's shard_map bodies call four `jax.lax` collectives:
`all_to_all(tiled=True)` for the NTT's transpose
(`homulator_tpu/ops/ntt.py:77`), `all_gather` and `axis_index` for the
gather-route automorphism (`ops/automorph.py:63-67`) and the limb
dispatch's row-block gathers (`parallel/limb_sharded.py:452`), and
`ppermute` for the shard-permutation automorphism (`:123`). Here they are
one interface, `Comm`: `rank`, `size`, `all_to_all(x, split_dim,
cat_dim)`, `all_gather(x, dim)` and `ppermute(x, pairs)`, with three
implementations:

  ThreadMesh(shape, device)  the shard programs as threads of one process
                          on one device. Each collective is a copy on that
                          device: the shards hand their operands over
                          through shared slots between two barriers. All
                          shards launch on the caller's current stream, so
                          stream order puts every exchange after the
                          launches that produced its input. One shard at a
                          time runs its host code (see ThreadMesh).
  DistMesh(group)         one shard per process through torch.distributed
                          (gloo on the CPU, NCCL on a machine with a card
                          per shard); `DistMesh.grid` builds a mesh of
                          named axes from `dist.new_group` subgroups.
  StandInMesh(shape, device)  shard 0 of one row alone in the caller's
                          thread, each collective a local copy of the
                          real result's shape (values meaningless): one
                          shard's program timed on one device, e.g. in a
                          CUDA graph; `standin_programs` builds shard 0's
                          hmult and hrotate of each sharded dispatch on
                          one (scripts/scaling_projection_torch.py).

A mesh is d data rows (the JAX meshes' "data" axis: `data=d`) of shards
laid out row-major over one or more named axes, e.g. `("limb",)` or
`("limb", "coeff")`. A shard's Comm runs its collectives over its row
(`row`; `index` = row * size + rank is its place in the mesh's row-major
list of shards), and `comm.axis(name)` is its Comm over one axis: the
shards of its row that share every other coordinate, with that axis's
coordinate as `rank` and its extent as `size` (on a mesh of one axis, the
row's Comm itself).

Every Comm counts in `recv_bytes` the bytes its rank received from other
ranks (a rank's own chunk is not counted, as in
`parallel/sharded.ici_bytes_per_op`) and in `calls` its collective calls;
`total_recv_bytes` sums a shard's Comms.

A shard program finds its Comm through `current()`, bound by the mesh for
the thread that runs it, as shard_map binds the axis name that the
collectives inside it use: the sharded NTT (ops/ntt.py) takes it from
there. A program that runs transforms over one axis of a larger mesh
binds that axis's Comm with `bound(comm.axis(name))`.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

_LOCAL = threading.local()


def current() -> "Comm":
    """The Comm of the shard program running in this thread."""
    comm = getattr(_LOCAL, "comm", None)
    if comm is None:
        raise RuntimeError("no shard program is running in this thread: "
                           "call sharded ops through a mesh's run()")
    return comm


@contextlib.contextmanager
def bound(comm: "Comm"):
    """Bind comm as this thread's `current()` for the block."""
    prev = getattr(_LOCAL, "comm", None)
    _LOCAL.comm = comm
    try:
        yield comm
    finally:
        _LOCAL.comm = prev


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sources(pairs: Sequence[Tuple[int, int]], size: int) -> Dict[int, int]:
    """ppermute pairs (src, dst) -> {dst: src}; each rank sends and
    receives at most once."""
    src_of: Dict[int, int] = {}
    srcs = set()
    for s, d in pairs:
        if not (0 <= s < size and 0 <= d < size):
            raise ValueError(f"ppermute pair {(s, d)} outside {size} ranks")
        if d in src_of or s in srcs:
            raise ValueError(f"ppermute pairs {list(pairs)} repeat a rank")
        src_of[d] = s
        srcs.add(s)
    return src_of


def _check_split(x: torch.Tensor, dim: int, size: int) -> None:
    if x.shape[dim] % size:
        raise ValueError(f"all_to_all: axis {dim} of {tuple(x.shape)} does "
                         f"not split into {size} chunks")


def _mesh_shape(shape, names) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(extents, axis names) of a mesh's row: shape an int or a tuple of
    extents, names one distinct name per axis ("data" is the rows'), or
    None for an unnamed mesh of one axis."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    names = () if names is None else tuple(names)
    if not shape or min(shape) < 1:
        raise ValueError(f"mesh extents {shape} must be >= 1")
    if names and len(names) != len(shape):
        raise ValueError(f"{len(names)} axis names {names} for a mesh of "
                         f"{len(shape)} axes")
    if not names and len(shape) > 1:
        raise ValueError("a mesh of several axes names them")
    if len(set(names)) != len(names) or "data" in names:
        raise ValueError(f"axis names {names} must be distinct and not "
                         "'data' (the rows)")
    return shape, names


def _axis_groups(shape: Tuple[int, ...], k: int) -> List[List[int]]:
    """The row ranks of each group along axis k: for every combination of
    the other coordinates, the ranks that differ only in coordinate k, in
    the order of that coordinate."""
    others = [range(e) if j != k else (0,) for j, e in enumerate(shape)]
    return [[int(sum(c * math.prod(shape[j + 1:]) for j, c in enumerate(
        base[:k] + (i,) + base[k + 1:]))) for i in range(shape[k])]
        for base in itertools.product(*others)]


class Comm:
    """One rank's view of a mesh: its index, the mesh size and the
    collectives over the mesh (see the module docstring)."""

    rank: int
    size: int
    row: int = 0
    recv_bytes: int
    calls: int
    shard: "Comm"  # the shard's row Comm (itself on a row Comm)
    _axes: Dict[str, "Comm"]

    @property
    def index(self) -> int:
        """This shard's place in its mesh's row-major shard list."""
        s = self.shard
        return s.row * s.size + s.rank

    def axis(self, name: str) -> "Comm":
        """This shard's Comm over mesh axis `name`."""
        if name not in self._axes:
            raise ValueError(f"mesh has no axis {name!r} (axes: "
                             f"{tuple(self._axes)})")
        return self._axes[name]

    def _comms(self) -> List["Comm"]:
        """This shard's Comms: its row's and its axes', each once."""
        out: List[Comm] = [self]
        for c in self._axes.values():
            if all(c is not o for o in out):
                out.append(c)
        return out

    @property
    def total_recv_bytes(self) -> int:
        """Bytes this shard received over all its Comms."""
        return sum(c.recv_bytes for c in self._comms())

    def reset_counts(self) -> None:
        for c in self._comms():
            c.recv_bytes = 0
            c.calls = 0

    def all_to_all(self, x: torch.Tensor, split_dim: int,
                   cat_dim: int) -> torch.Tensor:
        """Split x into `size` chunks along split_dim, send chunk i to
        rank i, and concatenate the chunks received, in rank order, along
        cat_dim (`jax.lax.all_to_all(..., tiled=True)`)."""
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's x concatenated in rank order along dim."""
        raise NotImplementedError

    def ppermute(self, x: torch.Tensor,
                 pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """Rank d receives x of rank s for each pair (s, d); a rank that
        is no pair's destination gets zeros (`jax.lax.ppermute`)."""
        raise NotImplementedError


class _ThreadComm(Comm):
    """A shard's Comm over one exchange group of a ThreadMesh (`gid`): its
    row, or one axis's group. `shard` is the shard's row Comm, which holds
    the baton for all of the shard's Comms."""

    def __init__(self, mesh: "ThreadMesh", row: int, rank: int, size: int,
                 gid: int, shard: Optional["_ThreadComm"] = None):
        self.mesh = mesh
        self.row = row
        self.rank = rank
        self.size = size
        self.gid = gid
        self.shard = self if shard is None else shard
        self.recv_bytes = 0
        self.calls = 0
        self.holds_baton = False
        self._axes = {}

    def all_to_all(self, x, split_dim, cat_dim):
        _check_split(x, split_dim, self.size)
        got = self.mesh._exchange(self, x.chunk(self.size, split_dim))
        parts = [chunks[self.rank] for chunks in got]
        self.recv_bytes += sum(_nbytes(p) for j, p in enumerate(parts)
                               if j != self.rank)
        return torch.cat(parts, cat_dim)

    def all_gather(self, x, dim):
        got = self.mesh._exchange(self, x)
        self.recv_bytes += sum(_nbytes(p) for j, p in enumerate(got)
                               if j != self.rank)
        return torch.cat(got, dim)

    def ppermute(self, x, pairs):
        src = _sources(pairs, self.size).get(self.rank)
        got = self.mesh._exchange(self, x)
        if src is None:
            return torch.zeros_like(x)
        if src != self.rank:
            self.recv_bytes += _nbytes(got[src])
        return got[src].clone()


class ThreadMesh:
    """The shard programs of a mesh as threads of this process on one
    device: `shape` shards a row (an int, or a tuple of extents of the axes
    `names`, row-major), `data` rows, each row exchanging only within
    itself and each axis group only within itself.

    `run(body)` calls body(comm) once per shard, each in its own thread
    with that shard's row Comm bound (`current()`), and returns the results
    in row-major order (`Comm.index`). Each exchange group waits on its
    own `threading.Barrier` with a timeout: a shard that raises aborts
    every barrier, so the others stop at their next exchange on any axis,
    and `run` re-raises the first failure. A run never hangs and never
    returns a partial result.

    A shard runs its host code only while it holds the mesh's baton, a
    lock it gives up while it waits at an exchange. The shards' host code
    is serialised by the interpreter lock anyway; without the baton, ns
    threads that each release that lock at every torch call hand it to
    each other at every call, and on an H100 host 4 shards took 106 ms
    per set-B hmult where the card was busy for 7.4 ms of it."""

    def __init__(self, shape, device="cuda", timeout: float = 300.0, *,
                 data: int = 1, names: Optional[Sequence[str]] = None):
        self.shape, self.names = _mesh_shape(shape, names)
        if data < 1:
            raise ValueError(f"ThreadMesh needs data >= 1, got {data}")
        self.size = math.prod(self.shape)
        self.data = data
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ThreadMesh(device='cuda'): "
                               "torch.cuda.is_available() is False")
        self.timeout = timeout
        self.comms = [_ThreadComm(self, row, r, self.size, row)
                      for row in range(data) for r in range(self.size)]
        self._group_sizes = [self.size] * data  # exchange group -> ranks
        for k, name in enumerate(self.names):
            if len(self.shape) == 1:  # the row is the axis
                for c in self.comms:
                    c._axes[name] = c
                continue
            for row in range(data):
                for members in _axis_groups(self.shape, k):
                    gid = len(self._group_sizes)
                    self._group_sizes.append(len(members))
                    for i, r in enumerate(members):
                        top = self.comms[row * self.size + r]
                        top._axes[name] = _ThreadComm(
                            self, row, i, len(members), gid, shard=top)
        self._slots: List[List[object]] = [[None] * n
                                           for n in self._group_sizes]
        self._barriers: List[threading.Barrier] = []
        self._baton = threading.Lock()

    def extent(self, name: str) -> int:
        """The number of shards along axis `name`."""
        if name not in self.names:
            raise ValueError(f"mesh has no axis {name!r} (axes: "
                             f"{self.names})")
        return self.shape[self.names.index(name)]

    @property
    def recv_bytes(self) -> List[int]:
        """Bytes each shard received from the others so far, over all its
        Comms, in row-major order."""
        return [c.total_recv_bytes for c in self.comms]

    def calls(self, axis: Optional[str] = None) -> List[int]:
        """Collective calls of each shard so far over axis `axis` (its
        row's Comm when None), in row-major order."""
        return [(c if axis is None else c.axis(axis)).calls
                for c in self.comms]

    def reset_counts(self) -> None:
        for c in self.comms:
            c.reset_counts()

    def _take_baton(self, shard: "_ThreadComm") -> None:
        if not self._baton.acquire(timeout=self.timeout):
            raise TimeoutError(f"ThreadMesh: no shard gave up the baton "
                               f"within {self.timeout} s")
        shard.holds_baton = True

    def _give_baton(self, shard: "_ThreadComm") -> None:
        if shard.holds_baton:
            shard.holds_baton = False
            self._baton.release()

    def _exchange(self, comm: "_ThreadComm", item) -> list:
        """Publish item, wait for every rank of comm's group, take a
        snapshot of all of theirs, and wait until each has taken its
        snapshot."""
        slots, barrier = self._slots[comm.gid], self._barriers[comm.gid]
        comm.calls += 1
        slots[comm.rank] = item
        self._give_baton(comm.shard)
        try:
            barrier.wait()
            got = list(slots)
            barrier.wait()
        finally:
            self._take_baton(comm.shard)
        return got

    def run(self, body: Callable[[Comm], object]) -> list:
        self._barriers = [threading.Barrier(n, timeout=self.timeout)
                          for n in self._group_sizes]
        results: List[object] = [None] * len(self.comms)
        errors: List[BaseException] = []  # in the order the shards failed
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def work(comm: _ThreadComm) -> None:
            try:
                self._take_baton(comm)
                with contextlib.ExitStack() as stack:
                    stack.enter_context(bound(comm))
                    if stream is not None:
                        stack.enter_context(torch.cuda.stream(stream))
                    results[comm.index] = body(comm)
            except BaseException as e:  # noqa: BLE001 - re-raised by run()
                errors.append(e)  # list.append is atomic
                for b in self._barriers:
                    b.abort()
            finally:
                self._give_baton(comm)

        threads = [threading.Thread(target=work, args=(c,),
                                    name=f"shard{c.row}.{c.rank}")
                   for c in self.comms]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            # the shard that failed first, not the others' broken barrier
            real = [e for e in errors
                    if not isinstance(e, threading.BrokenBarrierError)]
            raise (real or errors)[0]
        return results


class DistMesh(Comm):
    """This process's shard of a torch.distributed group (the default
    group when None). `run(body)` calls body(self) with this Comm bound
    and returns [its result]: the results of the shards this process
    runs, as ThreadMesh.run returns all of them. Every process of the
    group runs the same program.

    On a mesh of d data rows, group is this process's row (a group from
    `dist.new_group`, one per row) and row its index, data = d. `axes`
    maps axis names to this shard's DistMesh over each axis's group;
    `DistMesh.grid` builds them all."""

    def __init__(self, group=None, *, row: int = 0, data: int = 1,
                 axes: Optional[Dict[str, "DistMesh"]] = None):
        import torch.distributed as dist

        if not 0 <= row < data:
            raise ValueError(f"DistMesh: row {row} outside {data} data rows")
        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.row = row
        self.data = data
        self.recv_bytes = 0
        self.calls = 0
        self.shard = self
        self._axes = dict(axes or {})
        for c in self._axes.values():
            c.shard = self

    @classmethod
    def grid(cls, shape, names: Sequence[str], *,
             data: int = 1) -> "DistMesh":
        """This process's shard of a mesh of `data` rows of `shape` shards
        (extents of the axes `names`, row-major) over the whole world, in
        global rank order: every process calls it, in the same order, as
        `dist.new_group` requires. Builds each row's group (data > 1) and
        each axis's groups."""
        import torch.distributed as dist

        shape, names = _mesh_shape(shape, names)
        size = math.prod(shape)
        if dist.get_world_size() != data * size:
            raise ValueError(f"world of {dist.get_world_size()} processes "
                             f"for {data} rows of {shape}")
        row, rank = divmod(dist.get_rank(), size)
        rows = [dist.new_group(list(range(r * size, (r + 1) * size)))
                for r in range(data)] if data > 1 else [None]
        axes: Dict[str, DistMesh] = {}
        for k, name in enumerate(names):
            if len(shape) == 1:
                continue
            for r in range(data):
                for members in _axis_groups(shape, k):
                    g = dist.new_group([r * size + m for m in members])
                    if r == row and rank in members:
                        axes[name] = cls(g, row=row, data=data)
        mesh = cls(rows[row], row=row, data=data, axes=axes)
        if len(shape) == 1:
            mesh._axes[names[0]] = mesh
        mesh.shape, mesh.names = shape, names
        return mesh

    def extent(self, name: str) -> int:
        """The number of shards along axis `name`."""
        return self.axis(name).size

    def run(self, body: Callable[[Comm], object]) -> list:
        with bound(self):
            return [body(self)]

    def _peer(self, r: int) -> int:
        """Group rank -> global rank (what point-to-point calls take)."""
        if self.group is None:
            return r
        return self._dist.get_global_rank(self.group, r)

    def all_to_all(self, x, split_dim, cat_dim):
        _check_split(x, split_dim, self.size)
        self.calls += 1
        inp = torch.stack(x.chunk(self.size, split_dim))  # [size, ...]
        out = torch.empty_like(inp)
        self._dist.all_to_all_single(out, inp, group=self.group)
        self.recv_bytes += _nbytes(out) * (self.size - 1) // self.size
        return torch.cat(list(out.unbind(0)), cat_dim)

    def all_gather(self, x, dim):
        self.calls += 1
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._dist.all_gather(parts, x, group=self.group)
        self.recv_bytes += _nbytes(x) * (self.size - 1)
        return torch.cat(parts, dim)

    def ppermute(self, x, pairs):
        dist = self._dist
        self.calls += 1
        src_of = _sources(pairs, self.size)
        dst = {s: d for d, s in src_of.items()}.get(self.rank)
        src = src_of.get(self.rank)
        x = x.contiguous()
        ops = []
        if dst is not None and dst != self.rank:
            ops.append(dist.P2POp(dist.isend, x, self._peer(dst), self.group))
        if src is None:
            out = torch.zeros_like(x)
        elif src == self.rank:
            out = x.clone()
        else:
            out = torch.empty_like(x)
            ops.append(dist.P2POp(dist.irecv, out, self._peer(src),
                                  self.group))
            self.recv_bytes += _nbytes(out)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out


class _StandInComm(Comm):
    """Rank 0's Comm of a StandInMesh over its row or one axis: each
    collective returns what rank 0 would receive in shape, built from
    copies of its own operand, and counts the calls and bytes rank 0 of a
    real mesh counts (as _ThreadComm does)."""

    def __init__(self, size: int, shard: Optional["_StandInComm"] = None):
        self.rank = 0
        self.size = size
        self.shard = self if shard is None else shard
        self.recv_bytes = 0
        self.calls = 0
        self._axes = {}

    def all_to_all(self, x, split_dim, cat_dim):
        _check_split(x, split_dim, self.size)
        self.calls += 1
        mine = x.chunk(self.size, split_dim)[0]
        self.recv_bytes += (self.size - 1) * _nbytes(mine)
        return torch.cat([mine] * self.size, cat_dim)

    def all_gather(self, x, dim):
        self.calls += 1
        self.recv_bytes += (self.size - 1) * _nbytes(x)
        return torch.cat([x] * self.size, dim)

    def ppermute(self, x, pairs):
        self.calls += 1
        src = _sources(pairs, self.size).get(0)
        if src is None:
            return torch.zeros_like(x)
        if src != 0:
            self.recv_bytes += _nbytes(x)
        return x.clone()


class StandInMesh:
    """Shard 0 of one row of a mesh, alone, in the caller's thread: the
    port of the JAX projection's `_patch_collectives`
    (`scripts/scaling_projection.py:80-130`), a third Comm beside
    ThreadMesh and DistMesh. It exists to time one shard's program on one
    device: the values it returns mean nothing.

    `shape`, `names`, `extent`, `size` and `data` (1) are a ThreadMesh's;
    `run(body)` calls body(comm) once, with shard 0's row Comm bound
    (`current()`), and returns [its result]; `comm.axis(name)` is a rank-0
    Comm over that axis. Every collective keeps the real result's shape
    and moves as many bytes on the device, as local copies of rank 0's own
    operand: all_gather concatenates `size` copies of it, all_to_all
    `size` copies of the chunk it keeps, ppermute clones it where rank 0
    is a destination (zeros where it is none). `recv_bytes` and `calls`
    count what a real shard 0 receives and calls, so a stand-in run can
    be held to `ici_bytes_per_op` and the collective counts. No thread,
    barrier or host synchronisation runs, so a stand-in shard program can
    be captured in a CUDA graph."""

    def __init__(self, shape, device="cuda", names: Optional[
            Sequence[str]] = None):
        self.shape, self.names = _mesh_shape(shape, names)
        self.size = math.prod(self.shape)
        self.data = 1
        self.device = torch.device(device)
        self.comm = _StandInComm(self.size)
        for k, name in enumerate(self.names):
            self.comm._axes[name] = (self.comm if len(self.shape) == 1 else
                                     _StandInComm(self.shape[k], self.comm))

    def extent(self, name: str) -> int:
        """The number of shards along axis `name`."""
        if name not in self.names:
            raise ValueError(f"mesh has no axis {name!r} (axes: "
                             f"{self.names})")
        return self.shape[self.names.index(name)]

    @property
    def recv_bytes(self) -> List[int]:
        """[bytes shard 0 would have received so far, over all its Comms]."""
        return [self.comm.total_recv_bytes]

    def calls(self, axis: Optional[str] = None) -> List[int]:
        """[shard 0's collective calls so far over `axis`] (its row's
        Comm when None)."""
        return [(self.comm if axis is None else self.comm.axis(axis)).calls]

    def reset_counts(self) -> None:
        self.comm.reset_counts()

    def run(self, body: Callable[[Comm], object]) -> list:
        with bound(self.comm):
            return [body(self.comm)]


def standin_programs(eng, level: int, axis: str, ns: int, ns_c: int,
                     cts):
    """(mesh, {"hmult": fn, "hrotate": fn}): shard 0's hmult and
    hrotate(1) programs of one dispatch on a StandInMesh on eng's device,
    axis "coeff" (ns shards, the JAX package's packing), "limb" (ns) or
    "hybrid" (ns limb x ns_c coeff), each fn() one call on shard 0's
    operands cut from the ciphertexts cts = (a, b) at `level`. Tables,
    routes and operands are made here, outside any captured call."""
    from . import limb_sharded as ls
    from . import sharded as sh

    dc, p = eng.dc, eng.params
    g = p.galois_elt(1)
    a, b = (c.data for c in cts)
    relin, rot = eng.relin_key, eng.rot_keys[1]
    if axis == "coeff":
        mesh = StandInMesh(ns, dc.device)
        fh = sh.make_shardmap_hmult(dc, level, mesh)
        fr = sh.make_shardmap_hrotate(dc, level, mesh)
        route = dc.automorph_shard_route(g, ns)
        a0, b0, k0, r0 = (sh.shard_cols(t, ns)[:1] for t in (a, b, relin,
                                                              rot))
    else:
        nl, nc = (ns, 1) if axis == "limb" else (ns, ns_c)
        if nc == 1:
            mesh = StandInMesh(nl, dc.device, names=("limb",))
            fh = ls.make_limb_hmult(dc, level, mesh)
            fr = ls.make_limb_hrotate(dc, level, mesh)
            route = dc.automorph_perm(g)
        else:
            mesh = StandInMesh((nl, nc), dc.device, names=("limb", "coeff"))
            fh = ls.make_hybrid_hmult(dc, level, mesh)
            fr = ls.make_hybrid_hrotate(dc, level, mesh)
            route = dc.automorph_shard_route(g, nc)
        a0, b0 = (ls.shard_rows(t, level, nl, nc)[:1] for t in (a, b))
        k0, r0 = (ls.limb_key(t, p, level, nl, nc)[:1] for t in (relin, rot))
    return mesh, {"hmult": lambda: fh(a0, b0, k0),
                  "hrotate": lambda: fr(a0, route, r0)}
