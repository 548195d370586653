"""The share of the traced window in which the device is idle (no kernel,
copy or memset: the complement of the union that ``device_idle_pct``
reads) while one of the program's compute stages is open: the card waiting
on the program's own launches.  At most ``device_idle_pct``; the rest of
the idle time falls in the program's ``input`` and ``fetch``, between its
stages, or outside every span (the caller's own work, such as the train
mix copying each batch to the card)."""

from benchmark.harness import program_spans as ps


def read(window):
    spans = ps.spans(window)
    if spans is None or window.timeline.window_s <= 0:
        return None
    compute = ps.intervals(window, ps.named(spans, ps.COMPUTE))
    idle = ps.seconds(compute) - ps.overlap(compute, window.timeline.busy())
    return 100.0 * idle / window.timeline.window_s
