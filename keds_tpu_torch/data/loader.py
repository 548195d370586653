"""Batching loader (counterpart of ``keds_tpu/data/loader.py``).

The epoch order is the JAX package's: ``np.random.default_rng(seed +
epoch).permutation(n)`` when shuffling, reseeded by :meth:`set_epoch`, the
same on every rank.  With ``world_size`` ranks it is padded (from its head)
to a multiple of the ranks, and global step t takes the contiguous slice
``[t B W, (t + 1) B W)`` of it, rank r the block ``[r B, (r + 1) B)`` of
that slice: contiguous blocks, not torch ``DistributedSampler``'s stride,
so that the ranks' blocks in rank order are the batch one process would
read, and every rank can compute a property of the global batch
(:meth:`global_batch_indices`) from the dataset alone.

A batch's samples are read by the calling thread, or by a pool of
``num_workers`` threads, or (``worker_processes``) spawned processes, which
receive the dataset once; numpy leaves are stacked and strings (the text
stream's subjects) listed.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import Executor, ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any, Iterator, Optional, Sequence

import numpy as np

# The object of a worker process, shipped once by the pool's initializer
# (per task it would be pickled again).
_WORKER_STATE = None


def _worker_init(state) -> None:
    global _WORKER_STATE
    _WORKER_STATE = state


def worker_call(method: str, *args):
    """``method(*args)`` of the worker process's object (a pool task)."""
    return getattr(_WORKER_STATE, method)(*args)


def spawn_pool(workers: int, state) -> ProcessPoolExecutor:
    """A pool of ``workers`` spawned processes, each holding a copy of
    ``state`` for :func:`worker_call`."""
    return ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_worker_init, initargs=(state,))


def default_collate(samples: Sequence[Any]):
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(default_collate([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, np.ndarray):
        return np.stack(samples)
    return list(samples)


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, num_workers: int = 0, rank: int = 0,
                 world_size: int = 1, worker_processes: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.rank = rank
        self.world_size = world_size
        self.worker_processes = worker_processes
        self._proc_pool: Optional[ProcessPoolExecutor] = None
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle for ``epoch``."""
        self.epoch = epoch

    def _full_indices(self) -> np.ndarray:
        """This epoch's order, the same on every rank, padded from its head
        to a multiple of ``world_size``."""
        n = len(self.dataset)
        idx = (np.random.default_rng(self.seed + self.epoch).permutation(n) if self.shuffle
               else np.arange(n))
        pad = (-n) % self.world_size
        return np.concatenate([idx, idx[:pad]]) if pad else idx

    def indices(self) -> np.ndarray:
        """This rank's sample order (the JAX package's ``_indices``): its
        block of each global step's slice of :meth:`_full_indices`."""
        full = self._full_indices()
        if self.world_size == 1:
            return full
        gb = self.batch_size * self.world_size
        out = []
        for start in range(0, len(full), gb):
            g = full[start:start + gb]
            m = len(g) // self.world_size    # a multiple: the ragged tail splits too
            out.append(g[self.rank * m:(self.rank + 1) * m])
        return np.concatenate(out) if out else full

    def global_batch_indices(self) -> Iterator[np.ndarray]:
        """Each step's global sample indices, the same on every rank; zip
        with the iteration after :meth:`set_epoch`."""
        full = self._full_indices()
        gb = self.batch_size * self.world_size
        for t in range(self.num_batches):
            yield full[t * gb:(t + 1) * gb]

    @property
    def num_batches(self) -> int:
        n = len(self.indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @property
    def num_samples(self) -> int:
        return len(self.dataset)

    def __len__(self) -> int:
        return self.num_batches

    def _pool(self) -> Optional[Executor]:
        """The thread pool of one iteration, or the process pool of the
        loader (kept across epochs: spawning workers costs seconds)."""
        if self.num_workers <= 0:
            return None
        if not self.worker_processes:
            return ThreadPoolExecutor(self.num_workers)
        if self._proc_pool is None:
            self._proc_pool = spawn_pool(self.num_workers, self.dataset)
        return self._proc_pool

    def __iter__(self) -> Iterator:
        idx = self.indices()
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(self.num_batches)]
        pool = self._pool()
        if pool is None:
            for b in batches:
                yield default_collate([self.dataset[int(i)] for i in b])
            return
        def submit(b):
            if self.worker_processes:
                return [pool.submit(worker_call, "__getitem__", int(i)) for i in b]
            return [pool.submit(self.dataset.__getitem__, int(i)) for i in b]

        pending = []
        try:
            pending = submit(batches[0]) if batches else []
            for j in range(len(batches)):
                current = pending
                # the next batch decodes while this one is consumed
                pending = submit(batches[j + 1]) if j + 1 < len(batches) else []
                yield default_collate([f.result() for f in current])
        finally:
            for f in pending:
                f.cancel()
            if not self.worker_processes:
                pool.shutdown(wait=False)

    def close(self) -> None:
        """Shut the process pool down (idempotent)."""
        if self._proc_pool is not None:
            self._proc_pool.shutdown(wait=False, cancel_futures=True)
            self._proc_pool = None
