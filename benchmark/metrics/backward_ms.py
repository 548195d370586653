"""Device ms of the training step's backward: CUDA events at its
``mark("text_tower_forward")`` and ``mark("backward")`` hooks, averaged
over the traced steps."""


def read(window):
    ms = window.marks.get("backward_ms")
    return sum(ms) / len(ms) if ms else None
