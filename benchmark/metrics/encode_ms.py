"""Device ms of the training step's frozen encode: CUDA events recorded at
the step's start and at its ``mark("encode")`` hook (``make_train_step``),
averaged over the traced steps."""


def read(window):
    ms = window.marks.get("encode_ms")
    return sum(ms) / len(ms) if ms else None
