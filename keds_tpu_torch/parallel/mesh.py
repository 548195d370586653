"""Process group and data-parallel helpers (counterpart of
``keds_tpu/parallel/mesh.py``).

The JAX package lays a 1-D ``data`` mesh over devices, one process per
host.  The torch idiom is one process per device: a :class:`Mesh` is this
process's place in the group, its rank, the world size and its device.  A
batch splits into contiguous rank blocks, rank-major, as the JAX package
lays a batch over its mesh, so that W ranks compute what one process
computes on the global batch.

* :func:`maybe_init_distributed` brings the group up from ``RANK``,
  ``WORLD_SIZE`` (``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) and ``--dist-url``;
  :func:`select_backend` picks its backend: gloo on the CPU, NCCL when each
  rank has a CUDA device of its own, gloo when ranks share one (NCCL
  refuses two ranks on one device).  gloo moves CUDA tensors through the
  host; :attr:`Mesh.comm` counts that traffic and its host-clock seconds.
* A rank's training rows are already its block of the global batch (the
  loader deals contiguous blocks); :func:`shard_global_batch` is the eval
  and serving feed (every rank holds the same global batch and keeps its
  block), :func:`shard_rows` splits a table's rows (the sharded DB and
  corpus).
* :func:`fetch_global` and :func:`fetch_batches` give every rank all ranks'
  rows in global order; :func:`gather_with_grad` does so with the rank's
  own rows carrying its gradient (the image stream's InfoNCE);
  :func:`all_reduce_sum` sums in place.

Without a group, :func:`make_mesh` gives a mesh of one rank and every
helper is the identity.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from keds_tpu_torch.runtime import DeviceLike, resolve_device

# A rank that fails leaves the others in a collective; they give up after
# this long instead of waiting forever.
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass
class CommStats:
    """Collectives of one mesh: calls, payload bytes and host-clock seconds
    (for the host-staged gloo path, the device-host copies included)."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0


@dataclasses.dataclass(eq=False)
class Mesh:
    """This process's place in a 1-D data-parallel group."""

    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None     # None: one process, no group
    comm: CommStats = dataclasses.field(default_factory=CommStats)


def select_backend(device_type: str, ranks_on_host: int, devices_on_host: int) -> str:
    """gloo for CPU tensors; nccl when every rank of the host has a CUDA
    device of its own; gloo when ranks share one."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if devices_on_host >= ranks_on_host else "gloo"


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _device_type(device: DeviceLike) -> str:
    return "cuda" if device is None else torch.device(device).type


def maybe_init_distributed(cfg=None) -> bool:
    """Bring the process group up for ``--distributed`` from RANK and
    WORLD_SIZE (LOCAL_RANK and LOCAL_WORLD_SIZE default to them, one host)
    with ``--dist-url`` as the init method.  A second call does nothing;
    WORLD_SIZE <= 1 stays single-process.  Returns whether a group is up."""
    if dist.is_initialized():
        return True
    if cfg is None or not cfg.distributed:
        return False
    world = _env_int("WORLD_SIZE", 1)
    if world <= 1:
        logging.warning("--distributed set but WORLD_SIZE<=1; single-process")
        return False
    rank = _env_int("RANK", 0)
    local_rank = _env_int("LOCAL_RANK", rank)
    dev_type = _device_type(cfg.device)
    n_dev = torch.cuda.device_count() if dev_type == "cuda" else 0
    if dev_type == "cuda":
        if n_dev == 0:
            raise RuntimeError("no CUDA device available; pass --device cpu to run the "
                               "ranks on the CPU")
        torch.cuda.set_device(local_rank % n_dev)
    backend = select_backend(dev_type, _env_int("LOCAL_WORLD_SIZE", world), n_dev)
    dist.init_process_group(backend, init_method=cfg.dist_url, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    logging.info("torch.distributed initialized via --dist-url %s: rank %d/%d, backend %s "
                 "(%s device(s) for %s rank(s) on this host)", cfg.dist_url, rank, world,
                 backend, n_dev if dev_type == "cuda" else "no CUDA",
                 _env_int("LOCAL_WORLD_SIZE", world))
    return True


def make_mesh(num_partitions: int = 0, device: DeviceLike = None) -> Mesh:
    """The mesh over every rank of the group (one rank without a group).
    ``num_partitions`` 0 means every rank; more than the world size is
    clamped to it with the JAX package's warning.  Fewer ranks than the
    world is the JAX package's ``ValueError``: with one device a process, a
    subset would leave some processes without a mesh device.  The rank's
    device is ``device``'s type, and for CUDA without an index
    ``cuda:{LOCAL_RANK % device_count}``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_partitions > world:
        logging.warning("make_mesh: %d devices requested, %d available — using all",
                        num_partitions, world)
    elif 0 < num_partitions < world:
        raise ValueError(f"--num-partitions {num_partitions} must be a positive multiple "
                         f"of the process count ({world}) so every host keeps local mesh "
                         "devices")
    if world == 1:
        return Mesh(0, 1, resolve_device(device))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _env_int("LOCAL_RANK", dist.get_rank())
                           % torch.cuda.device_count())
    return Mesh(dist.get_rank(), world, resolve_device(dev), dist.get_backend())


def _distributed(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.size > 1


def _timed(mesh: Mesh, x: torch.Tensor, op) -> torch.Tensor:
    """``op(wire)`` on ``x``'s copy the backend takes (gloo: host memory),
    the result back on ``x``'s device; counted in ``mesh.comm``."""
    staged = mesh.backend == "gloo" and x.device.type == "cuda"
    if staged:
        torch.cuda.synchronize(x.device)       # time the transport, not the queue
    t0 = time.perf_counter()
    wire = x.detach().cpu() if staged else x.detach().contiguous()
    out = op(wire)
    out = out.to(x.device) if staged else out
    mesh.comm.calls += 1
    mesh.comm.bytes += wire.numel() * wire.element_size()
    mesh.comm.seconds += time.perf_counter() - t0
    return out


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(W, *x.shape): every rank's ``x`` (one shape on every rank) in rank
    order, on ``x``'s device, without gradient."""
    if not _distributed(mesh):
        return x.detach()[None]

    def op(wire):
        parts = [torch.empty_like(wire) for _ in range(mesh.size)]
        dist.all_gather(parts, wire)
        return torch.stack(parts)

    return _timed(mesh, x, op)


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the ranks in place (and return it)."""
    if not _distributed(mesh):
        return x

    def op(wire):
        dist.all_reduce(wire, op=dist.ReduceOp.SUM)
        return wire

    out = _timed(mesh, x, op)
    if out is not x:
        x.copy_(out)
    return x


def _block(mesh: Mesh, n: int) -> Tuple[int, int]:
    """(first row, rows) of this rank's contiguous block of ``n`` rows split
    into ``ceil(n / W)``-row blocks."""
    m = -(-n // mesh.size)
    return mesh.rank * m, m


def shard_rows(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s rows, zero rows padding them
    to a multiple of the world size (a row-sharded table; a block of an
    evenly split batch as it is)."""
    if not _distributed(mesh):
        return x
    lo, m = _block(mesh, int(x.shape[0]))
    part = x[lo:lo + m]
    if part.shape[0] < m:
        part = torch.cat([part, part.new_zeros((m - part.shape[0],) + tuple(x.shape[1:]))])
    return part


def shard_global_batch(mesh: Optional[Mesh], x, device: DeviceLike = None
                       ) -> Tuple[torch.Tensor, int]:
    """The eval and serving feed: every rank holds the same global batch
    ``x`` (numpy or tensor).  The tail is padded by repeating the last row
    up to a multiple of the world size; returns this rank's contiguous
    block on its device and the global row count."""
    n = int(x.shape[0])
    if not _distributed(mesh):
        return torch.as_tensor(x, device=device if mesh is None else mesh.device), n
    lo, m = _block(mesh, n)
    rows = np.minimum(np.arange(lo, lo + m), n - 1)
    block = x[rows] if isinstance(x, np.ndarray) else x[torch.as_tensor(rows, device=x.device)]
    return torch.as_tensor(block, device=mesh.device), n


def batch_rows(mesh: Optional[Mesh], n_local: int) -> Optional[Tuple[int, int]]:
    """(first global row, global rows) of this rank's ``n_local`` rows of an
    evenly split batch; None without a group."""
    if not _distributed(mesh):
        return None
    return mesh.rank * n_local, mesh.size * n_local


def fetch_global(mesh: Optional[Mesh], x: torch.Tensor,
                 n: Optional[int] = None) -> torch.Tensor:
    """All ranks' rows of ``x`` in rank order, trimmed to ``n``, on ``x``'s
    device.  Blocks of unequal length are padded to equal shapes for the
    all-gather and trimmed after it."""
    if not _distributed(mesh):
        return x[:n]
    sizes = all_gather(mesh, torch.tensor([x.shape[0]], device=x.device))[:, 0].tolist()
    top = max(sizes)
    if x.shape[0] < top:
        x = torch.cat([x, x.new_zeros((top - x.shape[0],) + tuple(x.shape[1:]))])
    parts = all_gather(mesh, x)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)])[:n]


def fetch_batches(mesh: Optional[Mesh], x: torch.Tensor,
                  counts: Sequence[int]) -> torch.Tensor:
    """Global rows of several batches fed by :func:`shard_global_batch`:
    ``x`` is this rank's blocks of batches of ``counts`` rows, concatenated.
    One all-gather, then each batch's blocks in rank order, trimmed."""
    if not _distributed(mesh):
        return x
    per = [-(-n // mesh.size) for n in counts]
    if x.shape[0] != sum(per):
        raise ValueError(f"{x.shape[0]} local rows for batches of {list(counts)} rows "
                         f"over {mesh.size} ranks (want {sum(per)})")
    parts = all_gather(mesh, x)                      # (W, sum(per), ...)
    out, off = [], 0
    for n, m in zip(counts, per):
        out.append(parts[:, off:off + m].reshape((mesh.size * m,) + tuple(x.shape[1:]))[:n])
        off += m
    return torch.cat(out)


def gather_with_grad(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` in rank order; this rank's own block is
    ``x`` itself, so the gradient of a loss over the result flows back
    through this rank's rows only (the reference's all-gather of features
    before its InfoNCE)."""
    if not _distributed(mesh):
        return x
    parts: List[torch.Tensor] = list(all_gather(mesh, x))
    parts[mesh.rank] = x
    return torch.cat(parts)
