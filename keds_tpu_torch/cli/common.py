"""Plumbing shared by the command-line entry points (counterpart of
``keds_tpu/cli/common.py``).

* :func:`run_logging` brings up the process group of ``--distributed``,
  names the run, logs it to ``<logs>/<name>/out.log`` and stderr (DEBUG
  with ``--debug``), writes every setting to ``params.txt`` and yields the
  run directory; on exit it removes its log handlers.  Over several ranks
  rank 0 alone writes the files (and checks that the run is new, for every
  rank); the others log to stderr with a ``Rank N |`` prefix.
* :func:`setup_runtime` returns the rank's device (``--device``, the CUDA
  device by default; TF32 off) and its mesh.
* :func:`pad_batch` repeats the last row up to a full batch, so the ragged
  tail takes the batch size every other call has.
* :class:`ScalarWriters` appends scalars to ``scalars.jsonl``, and to
  TensorBoard or wandb when ``--report-to`` names them and they import.
* :func:`load_database` loads the knowledge DB of the flags in the compute
  dtype on the device, its rows split over the mesh with ``--db-shard``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Iterator, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from keds_tpu_torch.logging_utils import close_logging, dump_params, setup_logging
from keds_tpu_torch.parallel.mesh import Mesh, make_mesh, maybe_init_distributed


def experiment_name(cfg) -> str:
    """``--name``, or the run's settings with a UTC time suffix."""
    if cfg.name:
        return cfg.name
    name = (f"lr={cfg.lr}_wd={cfg.wd}_agg={cfg.aggregate}_model={cfg.model}"
            f"_batchsize={cfg.batch_size}_workers={cfg.workers}")
    if cfg.time_suffix:
        name += time.strftime("_date=%Y-%m-%d-%H-%M-%S", time.gmtime())
    return name.replace("/", "-")


def setup_experiment(cfg, require_fresh: bool = True) -> str:
    """Bring up the process group (:func:`maybe_init_distributed`), name the
    run, make its directory and install its logging; returns the run
    directory.  With ``require_fresh`` (training without ``--resume``) an
    existing run of that name is refused.  Over several ranks, rank 0's
    name and verdict go to every rank, and only rank 0 writes."""
    maybe_init_distributed(cfg)
    rank = dist.get_rank() if dist.is_initialized() else 0
    name = experiment_name(cfg)
    log_path = os.path.join(cfg.logs, name, "out.log")
    taken = require_fresh and cfg.resume is None and os.path.exists(log_path)
    if dist.is_initialized():
        shared = [name, taken]
        dist.broadcast_object_list(shared, src=0)
        name, taken = shared
    cfg.name = name
    log_dir = os.path.join(cfg.logs, cfg.name)
    if taken:
        raise SystemExit(f"Error. Experiment already exists at {log_dir}. "
                         "Use --name for a new one.")
    level = logging.DEBUG if cfg.debug else logging.INFO
    if rank > 0:
        setup_logging(None, level, rank=rank)
        return log_dir
    os.makedirs(log_dir, exist_ok=True)
    setup_logging(os.path.join(log_dir, "out.log"), level)
    dump_params(cfg, os.path.join(log_dir, "params.txt"))
    return log_dir


@contextlib.contextmanager
def run_logging(cfg, require_fresh: bool = True) -> Iterator[str]:
    """:func:`setup_experiment` for the length of a run; yields the run
    directory and removes the log handlers afterwards."""
    try:
        yield setup_experiment(cfg, require_fresh)
    finally:
        close_logging()


def setup_runtime(cfg) -> Tuple[torch.device, Mesh]:
    """The rank's device and the mesh over the ranks (of one rank without
    ``--distributed``)."""
    maybe_init_distributed(cfg)
    mesh = make_mesh(cfg.num_partitions, cfg.device)
    logging.info("device: %s; mesh: %d rank(s)%s", mesh.device, mesh.size,
                 f" over {mesh.backend}" if mesh.backend else "")
    return mesh.device, mesh


def pad_batch(arr, n: int) -> np.ndarray:
    """Pad the leading dim up to ``n`` by repeating the last row; callers
    slice results back to the true row count."""
    arr = np.asarray(arr)
    if arr.shape[0] >= n:
        return arr
    reps = np.repeat(arr[-1:], n - arr.shape[0], axis=0)
    return np.concatenate([arr, reps], axis=0)


def compute_dtype(cfg) -> torch.dtype:
    """f32 for ``--precision fp32``; amp, fp16 and bf16 all compute in bf16."""
    return torch.float32 if cfg.precision == "fp32" else torch.bfloat16


class ScalarWriters:
    """Scalar logging: ``<log_dir>/scalars.jsonl`` always; TensorBoard under
    ``<log_dir>/tensorboard`` and wandb when ``--report-to`` names them (or
    ``all``) and they import, else a warning."""

    def __init__(self, cfg, log_dir: str):
        self.sinks: List = []
        self.closers: List = []
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        report = cfg.report_to or ""
        if "tensorboard" in report or "all" in report:
            try:
                from torch.utils.tensorboard import SummaryWriter

                tb = SummaryWriter(os.path.join(log_dir, "tensorboard"))
                self.sinks.append(
                    lambda s, step: [tb.add_scalar(k, v, step) for k, v in s.items()])
                self.closers.append(tb.close)
            except Exception as e:  # an optional sink: the run goes on without it
                logging.warning("tensorboard unavailable: %s", e)
        if "wandb" in report or "all" in report:
            try:
                import wandb

                wandb.init(project="zcomp", notes=cfg.wandb_notes, config=vars(cfg))
                self.sinks.append(lambda s, step: wandb.log({**s, "step": step}))
            except Exception as e:  # an optional sink: the run goes on without it
                logging.warning("wandb unavailable: %s", e)

    def __call__(self, scalars: dict, step: int) -> None:
        self._jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
        self._jsonl.flush()
        for sink in self.sinks:
            sink(scalars, step)

    def close(self) -> None:
        self._jsonl.close()
        for close in self.closers:
            close()


def load_database(cfg, mesh: Mesh):
    """The knowledge DB of the flags, in the compute dtype on the mesh's
    device, wrapped in a :class:`Retriever` of ``--retrieval-backend``
    ('auto' is 'xla', as in the JAX package).  With ``--db-shard`` over
    several ranks the DB is read on the host and each rank keeps its block
    of the rows."""
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever

    backend = "xla" if cfg.retrieval_backend == "auto" else cfg.retrieval_backend
    if not (cfg.db_shard and mesh.size > 1):
        return Retriever(KnowledgeDB.from_config(cfg, compute_dtype(cfg), mesh.device),
                         backend)
    db = KnowledgeDB.from_config(cfg, compute_dtype(cfg), "cpu").shard_over(mesh)
    logging.info("knowledge DB rows split over %d ranks: %d here", mesh.size, db.size)
    return Retriever(db, backend)
