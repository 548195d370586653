"""Tracing and step timing (counterpart of ``keds_tpu/profiling.py``).

The reference imports torch.profiler but leaves it dormant, keeping only
its data/batch step timing (``src/trainer.py:455,480-508``).  Here:

* :func:`trace` — a context manager around :mod:`torch.profiler` that
  writes a Chrome trace of the CPU and, on the card, the CUDA kernels
  (TensorBoard's profile plugin lists it: ``tensorboard --logdir <dir>``;
  Perfetto and chrome://tracing open the ``.pt.trace.json`` itself);
* :func:`annotate` — a named range in that trace
  (``torch.profiler.record_function``);
* :class:`StepTimer` — the reference's data_time / batch_time counters.

The train CLI's ``--profile-dir`` traces steps 10-20 of its first epoch
(:func:`keds_tpu_torch.train.trainer.train_epoch`).
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
import time
from typing import Iterator, Optional

import torch


def start_trace(log_dir: str) -> torch.profiler.profile:
    """A started profiler of the CPU and, where CUDA is available, the
    CUDA kernels; :func:`stop_trace` writes it under ``log_dir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    logging.info("capturing a torch.profiler trace to %s", log_dir)
    return prof


def stop_trace(prof: torch.profiler.profile, log_dir: str) -> str:
    """Stop ``prof`` and write its Chrome trace to
    ``<log_dir>/<host>_<pid>.<time_ns>.pt.trace.json``, the name
    ``torch.profiler.tensorboard_trace_handler`` gives, which TensorBoard's
    profile plugin lists; returns the path."""
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                 f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    logging.info("profiler trace written to %s", path)
    return path


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the block into ``log_dir``; nothing without a directory."""
    if not log_dir:
        yield
        return
    prof = start_trace(log_dir)
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        stop_trace(prof, log_dir)


def annotate(name: str):
    """Named range visible in the trace viewer."""
    return torch.profiler.record_function(name)


class StepTimer:
    """data_time / batch_time accounting matching the reference's counters."""

    def __init__(self):
        self._end = time.time()
        self.data_time = 0.0
        self.batch_time = 0.0

    def data_ready(self) -> None:
        self.data_time = time.time() - self._end

    def step_done(self) -> None:
        now = time.time()
        self.batch_time = now - self._end
        self._end = now
