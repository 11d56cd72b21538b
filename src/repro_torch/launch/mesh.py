"""Meshes for tensor-parallel serving over ``torch.distributed`` ranks.

A mesh is a ``(data, model)`` grid over the ranks of a process group, one
process per rank.  Each rank drives one device: a card of its own under
NCCL, or, under gloo, the CPU or a card that every rank shares.  Axes, as in
the JAX reference:

  data   - data parallelism (serving slots sharded over replicas; not
           served yet: a serve mesh needs data = 1)
  model  - tensor/expert parallelism (heads, d_ff, vocab, experts, and the
           head-sharded paged KV pools)

Nothing here touches ``torch.distributed`` at import.  ``init_ranks`` starts
a group; the mesh functions read the group that is running (a process with
no group is a world of one rank).
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import socket
from typing import Any, Callable, Optional, Tuple

import torch.distributed as dist

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid over the first ``data * model`` ranks of a
    process group.  ``group`` is the group of those ranks (None for a world
    of one rank with no group); ``rank`` is this process's rank in it."""

    data: int
    model: int
    group: Any = None
    rank: int = 0

    axis_names = AXES

    @property
    def shape(self):
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model


def world_running() -> bool:
    """Whether this process belongs to a running default group."""
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(rank, size) of the running default group; (0, 1) without one."""
    if world_running():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def free_port() -> int:
    """A TCP port on localhost that is free now (for a group's rendezvous)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# how long a collective waits for a rank that does not come
RANK_TIMEOUT = datetime.timedelta(seconds=300)


def init_ranks(backend: str, rank: int, size: int, port: int):
    """Join this process to a ``size``-rank group over ``backend`` ("nccl"
    or "gloo") that meets at ``tcp://localhost:port``."""
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=size, timeout=RANK_TIMEOUT)


def _child(target, rank: int, size: int, port: int, backend: str, args):
    init_ranks(backend, rank, size, port)
    try:
        target(*args)
        dist.barrier()  # no rank tears down while another still talks
    finally:
        dist.destroy_process_group()


def launch(size: int, backend: str, target: Callable, *args):
    """Run ``target(*args)`` on ``size`` ranks of a new group over
    ``backend``: this process is rank 0, ranks 1.. are spawned processes
    (``target`` must be importable by module path).  Returns rank 0's
    result once every rank has ended; raises if any rank failed."""
    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child,
                         args=(target, r, size, port, backend, args))
             for r in range(1, size)]
    for p in procs:
        p.start()
    done = False
    try:
        init_ranks(backend, 0, size, port)
        try:
            out = target(*args)
            dist.barrier()
            done = True
        finally:
            dist.destroy_process_group()
    finally:
        for p in procs:  # after a failure here, the others may wait forever
            p.join(RANK_TIMEOUT.total_seconds() if done else 5)
            if p.is_alive():
                p.terminate()
                p.join()
    bad = [r for r, p in enumerate(procs, 1) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"rank(s) {bad} of {size} failed")
    return out


def _mesh_over(data: int, model: int) -> Mesh:
    rank, n = world()
    need = data * model
    if need == n:
        group = dist.group.WORLD if n > 1 else None
    else:  # the first ``need`` ranks (every rank must make the group)
        group = dist.new_group(list(range(need)))
    return Mesh(data, model, group, rank if rank < need else -1)


def make_host_mesh(model_axis: Optional[int] = None) -> Mesh:
    """Best-effort mesh over every rank: (data, model) with ``model_axis``
    dividing the rank count.

    An explicit ``model_axis`` is CLAMPED to the largest divisor of the rank
    count that does not exceed it (asking for model=8 in a world of one rank
    gives the trivial (1, 1) mesh)."""
    n = world()[1]
    if model_axis is None:
        model_axis = 1
        for cand in (16, 8, 4, 2):
            if n % cand == 0 and n >= cand:
                model_axis = cand
                break
    else:
        if model_axis < 1:
            raise ValueError(f"model_axis must be >= 1, got {model_axis}")
        model_axis = min(model_axis, n)
        while n % model_axis != 0:
            model_axis -= 1
    return _mesh_over(n // model_axis, model_axis)


def parse_mesh_shape(spec: str) -> Tuple[int, int]:
    """Parse an ``RxC`` mesh flag ("1x8" -> (1, 8)): (data, model) axes."""
    parts = spec.lower().split("x")
    if len(parts) != 2:
        raise ValueError(f"mesh spec must be RxC (e.g. 1x8), got {spec!r}")
    try:
        data, model = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"mesh spec must be RxC with integer axes, got {spec!r}") from None
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got {spec!r}")
    return data, model


def make_serve_mesh(data: int, model: int) -> Mesh:
    """A (data, model) mesh over the FIRST ``data * model`` ranks.

    Unlike :func:`make_host_mesh` this takes the requested shape literally,
    but it tolerates a group with MORE ranks than the mesh needs (the ranks
    past the mesh get ``rank == -1``).  Raises when the group has fewer."""
    need = data * model
    n = world()[1]
    if need > n:
        raise ValueError(
            f"mesh {data}x{model} needs {need} devices; only {n} available")
    return _mesh_over(data, model)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of a mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    if name not in mesh.axis_names:
        return 1
    return mesh.shape[name]


def dp_size(mesh) -> int:
    size = 1
    for a in dp_axes(mesh):
        size *= axis_size(mesh, a)
    return size
