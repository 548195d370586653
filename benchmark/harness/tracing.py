"""The traced window: ``torch.profiler`` over a few of the cell's calls, and
its timeline reduced to what the per-layer readers take.

Only the device is traced (CUPTI's kernels, copies and memsets, and the
CUDA runtime calls that issued them): recording every host operator as
well doubled a serving batch's host time.  Device activity is the union
of the intervals of every kernel, copy and memset on the device timeline
(overlaps count once); the window runs from the first traced event to the
end of the final synchronise.  Idle gaps are the window's stretches with
nothing on the device, each named by the runtime call open when it began,
or by the next one the host made.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch

Interval = Tuple[str, float, float]      # (name, start s, end s)


@dataclasses.dataclass
class Timeline:
    device: List[Interval]               # kernels, copies, memsets
    host: List[Interval]                 # host ranges and ops
    window: Tuple[float, float]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def clipped(self) -> List[Interval]:
        w0, w1 = self.window
        return [(n, max(a, w0), min(b, w1)) for n, a, b in self.device if b > w0 and a < w1]

    def busy(self) -> List[Tuple[float, float]]:
        """The union of device intervals inside the window."""
        out: List[Tuple[float, float]] = []
        for _, a, b in sorted(self.clipped(), key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def seconds(self, pattern: Optional[str] = None, exclude: Tuple[str, ...] = ()) -> float:
        """Summed device seconds of the events whose name matches
        ``pattern`` (all when None) and none of ``exclude``."""
        rx = re.compile(pattern, re.I) if pattern else None
        ex = [re.compile(p, re.I) for p in exclude]
        return sum(b - a for n, a, b in self.clipped()
                   if (rx is None or rx.search(n)) and not any(x.search(n) for x in ex))

    def gaps(self) -> List[Tuple[float, float]]:
        w0, w1 = self.window
        edges, t = [], w0
        for a, b in self.busy():
            if a > t:
                edges.append((t, a))
            t = max(t, b)
        if w1 > t:
            edges.append((t, w1))
        return edges

    def host_at(self, t: float) -> str:
        """The innermost host call open at ``t``, else 'host, before' the
        next one."""
        best, nxt = None, None
        for n, a, b in self.host:
            if a <= t < b and (best is None or a >= best[1]):
                best = (n, a)
            elif a > t and (nxt is None or a < nxt[1]):
                nxt = (n, a)
        if best:
            return best[0]
        return f"host, before {nxt[0]}" if nxt else "host"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for n, a, b in self.clipped():
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[self.host_at(a)[:160], b - a] for a, b in gaps]}


def _times(e) -> Tuple[float, float]:
    if hasattr(e, "start_ns"):
        start = e.start_ns() / 1e9
        return start, start + e.duration_ns() / 1e9
    start = e.start_us() / 1e6
    return start, start + e.duration_us() / 1e6


def timeline(prof) -> Timeline:
    """A finished ``torch.profiler.profile``'s events, split by device."""
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        a, b = _times(e)
        (device if e.device_type() == cuda else host).append((e.name(), a, b))
    events = device + host
    if not events:
        raise RuntimeError("the trace holds no event")
    return Timeline(device, host, (min(a for _, a, _ in events), max(b for *_, b in events)))


def capture(fn, device: torch.device):
    """Run ``fn()`` under the profiler, the device synchronised before the
    profile closes; returns (fn's result, Timeline).  On the CPU (the
    harness's own tests) the host's operators are traced instead."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return out, timeline(prof)
