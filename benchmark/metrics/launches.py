"""Kernel launch calls a step: the ``cudaLaunchKernel*`` (runtime API)
and ``cuLaunchKernel*`` (low-level API) calls in the traced host
timeline that start inside a step's span (an engine batch with its stages
and ranking, a train step)."""

from benchmark.harness import program_spans as ps


def read(window):
    spans = ps.spans(window)
    if spans is None:
        return None
    iv = ps.intervals(window, ps.steps(spans))
    n = sum(1 for name, a, _ in window.timeline.host if ps.LAUNCH.match(name) and ps.inside(a, iv))
    return n / len(ps.steps(spans))
