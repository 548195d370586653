"""The program's own spans in the traced window, for the ``program_span``
readers in ``metrics/``.

While a profile runs, ``keds_tpu_torch.profiling`` records a span at each
stage of the engine and the train step (name, start and end ns, id, parent,
step) on the clock the profiler stamps its events with, so they lie over
the timeline: the traced window's spans are those that overlap
``timeline.window``, and nothing needs resetting between runs.  A step
span (an engine batch, a train step) carries its own id as its step.  A
program without spans gives None, and so does a window without them.
"""

from __future__ import annotations

import bisect
import re
from typing import List, Optional, Sequence, Tuple

# The stages that issue the step's device work; the step's host time in
# them is how long the host takes to issue one step.
COMPUTE = ("encode", "retrieve", "fuse", "text", "rank", "backward", "all_reduce",
           "optimizer")
LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel)")

Intervals = List[Tuple[float, float]]     # sorted, disjoint, in seconds


def spans(window) -> Optional[list]:
    """The spans that overlap the traced window, or None; raises when the
    window's step spans are not one a traced step."""
    tl = window.timeline
    if tl is None:
        return None
    try:
        from keds_tpu_torch.profiling import SPANS
    except ImportError:                   # a program older than its spans
        return None
    w0, w1 = tl.window
    out = [s for s in list(SPANS) if s.end_ns / 1e9 > w0 and s.start_ns / 1e9 < w1]
    if not out:
        return None
    n = len(steps(out))
    if n != len(window.steps):
        raise ValueError(f"the traced window holds {n} step spans for "
                         f"{len(window.steps)} traced steps")
    return out


def steps(recorded: Sequence) -> list:
    return [s for s in recorded if s.step == s.id]


def union(pairs) -> Intervals:
    out: Intervals = []
    for a, b in sorted(pairs):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def intervals(window, recorded: Sequence) -> Intervals:
    """The union of the spans' intervals, clipped to the window."""
    w0, w1 = window.timeline.window
    return union((max(s.start_ns / 1e9, w0), min(s.end_ns / 1e9, w1)) for s in recorded)


def named(recorded: Sequence, names: Sequence[str]) -> list:
    return [s for s in recorded if s.name in names]


def seconds(iv: Intervals) -> float:
    return sum(b - a for a, b in iv)


def overlap(x: Intervals, y: Intervals) -> float:
    """Seconds that two unions share."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        total += max(0.0, b - a)
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def inside(t: float, iv: Intervals) -> bool:
    k = bisect.bisect_right(iv, (t, float("inf"))) - 1
    return k >= 0 and iv[k][0] <= t <= iv[k][1]
