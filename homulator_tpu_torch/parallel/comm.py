"""Collectives of the coefficient-sharded dispatch, and the meshes that run
its per-shard programs.

The JAX package's shard_map bodies call four `jax.lax` collectives:
`all_to_all(tiled=True)` for the NTT's transpose
(`homulator_tpu/ops/ntt.py:77`), `all_gather` and `axis_index` for the
gather-route automorphism (`ops/automorph.py:63-67`) and `ppermute` for the
shard-permutation automorphism (`:123`). Here they are one interface,
`Comm`: `rank`, `size`, `all_to_all(x, split_dim, cat_dim)`,
`all_gather(x, dim)` and `ppermute(x, pairs)`, with two implementations:

  ThreadMesh(ns, device)  the ns shard programs as ns threads of one
                          process on one device. Each collective is a copy
                          on that device: the shards hand their operands
                          over through shared slots between two barriers.
                          All shards launch on the caller's current stream,
                          so stream order puts every exchange after the
                          launches that produced its input. One shard at a
                          time runs its host code (see ThreadMesh).
  DistMesh(group)         one shard per process through torch.distributed
                          (gloo on the CPU, NCCL on a machine with a card
                          per shard).

A mesh may also have a data extent d (the JAX meshes' "data" axis): d rows
of ns coefficient shards, `ThreadMesh(ns, device, data=d)` or one DistMesh
per process over its row's process group. The collectives of a Comm run
within its row (`row`); `index` = row * ns + rank is its place in the
mesh's row-major list of shards.

Every Comm counts in `recv_bytes` the bytes its rank received from other
ranks; a rank's own chunk is not counted, as in
`parallel/sharded.ici_bytes_per_op`.

A shard program finds its Comm through `current()`, bound by the mesh for
the thread that runs it, as shard_map binds the axis name that the
collectives inside it use: the sharded NTT (ops/ntt.py) takes it from
there.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Sequence, Tuple

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
def _bound(comm: "Comm"):
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


class Comm:
    """One rank's view of a mesh: its index, the mesh size and the
    collectives over the mesh (see the module docstring)."""

    rank: int
    size: int
    row: int = 0
    recv_bytes: int

    @property
    def index(self) -> int:
        """This shard's place in its mesh's row-major shard list."""
        return self.row * self.size + self.rank

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
    def __init__(self, mesh: "ThreadMesh", row: int, rank: int):
        self.mesh = mesh
        self.row = row
        self.rank = rank
        self.size = mesh.size
        self.recv_bytes = 0
        self.holds_baton = False

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
    """ns shard programs as ns threads of this process on one device; with
    data=d, d rows of ns shards (d*ns threads), each row exchanging only
    within itself.

    `run(body)` calls body(comm) once per shard, each in its own thread
    with that shard's Comm bound (`current()`), and returns the results in
    row-major order (`Comm.index`). The exchanges of a row wait on its
    `threading.Barrier` with a timeout: a shard that raises aborts every
    barrier, so the others stop at their next exchange, and `run`
    re-raises the first failure. A run never hangs and never returns a
    partial result.

    A shard runs its host code only while it holds the mesh's baton, a
    lock it gives up while it waits at an exchange. The shards' host code
    is serialised by the interpreter lock anyway; without the baton, ns
    threads that each release that lock at every torch call hand it to
    each other at every call, and on an H100 host 4 shards took 106 ms
    per set-B hmult where the card was busy for 7.4 ms of it."""

    def __init__(self, ns: int, device="cuda", timeout: float = 300.0, *,
                 data: int = 1):
        if ns < 1 or data < 1:
            raise ValueError(f"ThreadMesh needs ns, data >= 1, got {ns}, "
                             f"{data}")
        self.size = ns
        self.data = data
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ThreadMesh(device='cuda'): "
                               "torch.cuda.is_available() is False")
        self.timeout = timeout
        self.comms = [_ThreadComm(self, row, r) for row in range(data)
                      for r in range(ns)]
        self._slots: List[List[object]] = [[None] * ns for _ in range(data)]
        self._barriers: List[threading.Barrier] = []
        self._baton = threading.Lock()

    @property
    def recv_bytes(self) -> List[int]:
        """Bytes each shard received from the others of its row so far, in
        row-major order."""
        return [c.recv_bytes for c in self.comms]

    def reset_counts(self) -> None:
        for c in self.comms:
            c.recv_bytes = 0

    def _take_baton(self, comm: "_ThreadComm") -> None:
        if not self._baton.acquire(timeout=self.timeout):
            raise TimeoutError(f"ThreadMesh: no shard gave up the baton "
                               f"within {self.timeout} s")
        comm.holds_baton = True

    def _give_baton(self, comm: "_ThreadComm") -> None:
        if comm.holds_baton:
            comm.holds_baton = False
            self._baton.release()

    def _exchange(self, comm: "_ThreadComm", item) -> list:
        """Publish item, wait for every rank of comm's row, take a
        snapshot of all of theirs, and wait until each has taken its
        snapshot."""
        slots, barrier = self._slots[comm.row], self._barriers[comm.row]
        slots[comm.rank] = item
        self._give_baton(comm)
        try:
            barrier.wait()
            got = list(slots)
            barrier.wait()
        finally:
            self._take_baton(comm)
        return got

    def run(self, body: Callable[[Comm], object]) -> list:
        self._barriers = [threading.Barrier(self.size, timeout=self.timeout)
                          for _ in range(self.data)]
        results: List[object] = [None] * len(self.comms)
        errors: List[BaseException] = []  # in the order the shards failed
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def work(comm: _ThreadComm) -> None:
            try:
                self._take_baton(comm)
                with contextlib.ExitStack() as stack:
                    stack.enter_context(_bound(comm))
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
    `dist.new_group`, one per row) and row its index, data = d."""

    def __init__(self, group=None, *, row: int = 0, data: int = 1):
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

    def reset_counts(self) -> None:
        self.recv_bytes = 0

    def run(self, body: Callable[[Comm], object]) -> list:
        with _bound(self):
            return [body(self)]

    def _peer(self, r: int) -> int:
        """Group rank -> global rank (what point-to-point calls take)."""
        if self.group is None:
            return r
        return self._dist.get_global_rank(self.group, r)

    def all_to_all(self, x, split_dim, cat_dim):
        _check_split(x, split_dim, self.size)
        inp = torch.stack(x.chunk(self.size, split_dim))  # [size, ...]
        out = torch.empty_like(inp)
        self._dist.all_to_all_single(out, inp, group=self.group)
        self.recv_bytes += _nbytes(out) * (self.size - 1) // self.size
        return torch.cat(list(out.unbind(0)), cat_dim)

    def all_gather(self, x, dim):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._dist.all_gather(parts, x, group=self.group)
        self.recv_bytes += _nbytes(x) * (self.size - 1)
        return torch.cat(parts, dim)

    def ppermute(self, x, pairs):
        dist = self._dist
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
