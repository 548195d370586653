"""The whole step's share of the card's bf16 peak: the model FLOPs of the
traced steps (counted from their shapes, harness/counts.py) over the traced
window's seconds and 989 TFLOP/s.  ``mfu.serve``, ``mfu.train`` and
``mfu.query`` read the same way in their own cells."""

from benchmark.harness import counts


def read(window):
    if window.timeline is None or not window.steps:
        return None
    flops = sum(counts.step_flops(window.config, s) for s in window.steps)
    return 100.0 * flops / window.timeline.window_s / counts.PEAK_BF16
