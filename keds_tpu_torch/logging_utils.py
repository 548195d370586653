"""Logging of the command-line runs (counterpart of ``keds_tpu/logging_utils.py``).

:func:`setup_logging` installs a stderr handler and, given a file, a file
handler on the root logger.  It is idempotent: a second call (a second CLI
``main()`` in one process) replaces the handlers it installed instead of
stacking a duplicate pair.  A rank above 0 prefixes every record with
``Rank N | `` once, however many handlers the record passes through.
:func:`dump_params` writes every config field to ``params.txt``.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_HANDLER_FLAG = "_keds_handler"


class _ProcessPrefixFilter(logging.Filter):
    """Rank prefix for multi-process logs.  One record passes through every
    handler's filters, so the prefix is applied once and flagged."""

    _FLAG = "_keds_rank_prefixed"

    def __init__(self, rank: int):
        super().__init__()
        self._rank = rank

    def filter(self, record: logging.LogRecord) -> bool:
        if self._rank > 0 and not getattr(record, self._FLAG, False):
            record.msg = f"Rank {self._rank} | {record.msg}"
            setattr(record, self._FLAG, True)
        return True


def close_logging() -> None:
    """Remove and close the handlers :func:`setup_logging` installed."""
    root = logging.getLogger()
    for h in [h for h in root.handlers if getattr(h, _HANDLER_FLAG, False)]:
        root.removeHandler(h)
        h.close()


def setup_logging(log_file: Optional[str] = None, level: int = logging.INFO,
                  rank: int = 0) -> None:
    close_logging()
    root = logging.getLogger()
    root.setLevel(level)
    fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s",
                            datefmt="%Y-%m-%d,%H:%M:%S")
    handlers = [logging.StreamHandler(sys.stderr)]
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    prefix = _ProcessPrefixFilter(rank)
    for h in handlers:
        h.setFormatter(fmt)
        h.setLevel(level)
        h.addFilter(prefix)
        setattr(h, _HANDLER_FLAG, True)
        root.addHandler(h)


def dump_params(cfg, path: str) -> None:
    """Write all config fields to ``path`` as ``name: value`` lines, sorted,
    and log each (reference src/main.py:104-111)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for name in sorted(vars(cfg)):
            val = getattr(cfg, name)
            logging.info(f"{name}: {val}")
            f.write(f"{name}: {val}\n")
