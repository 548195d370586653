"""Tracing and step timing (counterpart of ``keds_tpu/profiling.py``).

The reference imports torch.profiler but leaves it dormant, keeping only
its data/batch step timing (``src/trainer.py:455,480-508``).  Here:

* :func:`trace` — a context manager around :mod:`torch.profiler` that
  writes a Chrome trace of the CPU and, on the card, the CUDA kernels
  (TensorBoard's profile plugin lists it: ``tensorboard --logdir <dir>``;
  Perfetto and chrome://tracing open the ``.pt.trace.json`` itself);
* :func:`span` (also :func:`annotate`) — a named span of the program,
  recorded in :data:`SPANS` while a profile runs, and a range in the trace
  where the profile records the CPU (``torch.profiler.record_function``);
* :class:`StepTimer` — the reference's data_time / batch_time counters.

The train CLI's ``--profile-dir`` traces steps 10-20 of its first epoch
(:func:`keds_tpu_torch.train.trainer.train_epoch`), the serve CLI's its
query batches 1-10.

Spans record only while a ``torch.profiler`` profile runs, any profile of
any activities: outside one a span costs one check of the profiler's
enabled flag.  Their times are ``time.time_ns()``, the clock the profiler
stamps its events with (Unix epoch ns, the card's CUPTI timestamps
converted to it), so a reader lays them over the profile's events.  Spans
of one step (an engine batch, a train step) share the id of the step's
span.  The program's spans:

* ``engine.compose``, ``engine.search``, ``engine.encode_corpus``: a call;
* ``engine.batch`` (a step): one batch of a call, holding ``input`` (the
  batch onto the device), ``encode``, ``retrieve``
  (``Retriever.retrieve_features``), ``fuse``, ``text`` and ``rank``;
* ``fetch``: the results back to the host;
* ``train.step`` (a step): the stages ``encode``, ``retrieve``, ``fuse``,
  ``text``, ``backward``, ``all_reduce`` (under a mesh) and ``optimizer``,
  each ending at the step's ``mark`` hook of the same stage.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import socket
import threading
import time
from typing import Callable, Deque, Dict, Iterator, NamedTuple, Optional

import torch

# Spans kept in memory: the newest SPAN_CAPACITY, the oldest dropped first.
SPAN_CAPACITY = 1 << 16


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


class Span(NamedTuple):
    """One recorded span, its times in ns on the profiler's clock."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]   # the id of the span open around it
    step: Optional[int]     # the id of its step's span (a step span's own id)


SPANS: Deque[Span] = collections.deque(maxlen=SPAN_CAPACITY)
_ids = itertools.count()
_open = threading.local()        # each thread's stack of open spans
_profiling = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("name", "is_step", "id", "parent", "step", "start", "range")

    def __init__(self, name: str, is_step: bool):
        self.name, self.is_step = name, is_step

    def __enter__(self) -> "_OpenSpan":
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer else None
        self.step = self.id if self.is_step else (outer.step if outer else None)
        stack.append(self)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        stack = _open.stack
        while stack[-1] is not self:            # a stage left open by an exception
            stack[-1].__exit__(None, None, None)
        end = time.time_ns()
        self.range.__exit__(None, None, None)
        stack.pop()
        SPANS.append(Span(self.name, self.start, end, self.id, self.parent, self.step))


def span(name: str, step: bool = False):
    """A span of the program named ``name`` around the block; ``step``
    makes it a step's span, whose id the spans inside it carry.  Recorded
    only while a profile runs (see the module docstring)."""
    if not _profiling():
        return _NO_SPAN
    return _OpenSpan(name, step)


annotate = span     # the older name of a span in the trace viewer


def stage_spans(mark: Callable[[str], None], first: str,
                after: Dict[str, str]) -> Callable[[str], None]:
    """A step's stage-end hook ``mark`` made to record its stages as spans
    that follow one another: the span ``first`` opens now, and the returned
    hook, called as a stage ends, ends the open span, calls ``mark(stage)``
    and opens the span ``after[stage]`` (none where ``stage`` is not in
    ``after``).  Call it inside the step's span, which ends a stage still
    open.  Without a running profile it is ``mark`` itself."""
    if not _profiling():
        return mark
    current: Optional[_OpenSpan] = _OpenSpan(first, False).__enter__()

    def hook(stage: str) -> None:
        nonlocal current
        if current is not None:
            current.__exit__(None, None, None)
        mark(stage)
        nxt = after.get(stage)
        current = _OpenSpan(nxt, False).__enter__() if nxt else None

    return hook


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
