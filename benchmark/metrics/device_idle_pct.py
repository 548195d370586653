"""The share of the traced window in which nothing (no kernel, copy or
memset) ran on the device: the union of the device timeline's intervals,
not their sum."""


def read(window):
    tl = window.timeline
    if tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
