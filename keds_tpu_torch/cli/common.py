"""Plumbing shared by the command-line entry points (counterpart of
``keds_tpu/cli/common.py``), for one process on one device.

* :func:`run_logging` names the run, logs it to ``<logs>/<name>/out.log``
  and stderr (DEBUG with ``--debug``), writes every setting to
  ``params.txt`` and yields the run directory; on exit it removes its log
  handlers.
* :func:`setup_runtime` resolves ``--device`` (the CUDA device by default;
  TF32 off).  Multi-process runs and meshes are ROADMAP.md section A item 10.
* :func:`pad_batch` repeats the last row up to a full batch, so the ragged
  tail takes the batch size every other call has.
* :class:`ScalarWriters` appends scalars to ``scalars.jsonl``, and to
  TensorBoard or wandb when ``--report-to`` names them and they import.
* :func:`load_database` loads the knowledge DB of the flags in the compute
  dtype on the device.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Iterator, List

import numpy as np
import torch

from keds_tpu_torch.logging_utils import close_logging, dump_params, setup_logging


def experiment_name(cfg) -> str:
    """``--name``, or the run's settings with a UTC time suffix."""
    if cfg.name:
        return cfg.name
    name = (f"lr={cfg.lr}_wd={cfg.wd}_model={cfg.model}"
            f"_batchsize={cfg.batch_size}_workers={cfg.workers}")
    if cfg.time_suffix:
        name += time.strftime("_date=%Y-%m-%d-%H-%M-%S", time.gmtime())
    return name.replace("/", "-")


def setup_experiment(cfg, require_fresh: bool = True) -> str:
    """Name the run, make its directory and install its logging; returns the
    run directory.  With ``require_fresh`` (training without ``--resume``)
    an existing run of that name is refused."""
    cfg.name = experiment_name(cfg)
    log_dir = os.path.join(cfg.logs, cfg.name)
    log_path = os.path.join(log_dir, "out.log")
    if require_fresh and cfg.resume is None and os.path.exists(log_path):
        raise SystemExit(f"Error. Experiment already exists at {log_dir}. "
                         "Use --name for a new one.")
    os.makedirs(log_dir, exist_ok=True)
    setup_logging(log_path, logging.DEBUG if cfg.debug else logging.INFO)
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


def setup_runtime(cfg) -> torch.device:
    from keds_tpu_torch.runtime import resolve_device

    device = resolve_device(cfg.device)
    logging.info("device: %s", device)
    return device


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


def load_database(cfg, device: torch.device):
    """The knowledge DB of the flags, in the compute dtype on ``device``,
    wrapped in a :class:`Retriever` (every ``--retrieval-backend`` the port
    takes runs the exact fused top-k)."""
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever

    return Retriever(KnowledgeDB.from_config(cfg, compute_dtype(cfg), device))
