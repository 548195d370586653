"""Device ms per step (a batch, a training step or a request) of the
cuBLAS / cuDNN matrix products: the towers' and heads' GEMMs."""

PATTERN = r"gemm|nvjet|cutlass|xmma|cublas|splitkreduce|sm90_"


def read(window):
    if window.timeline is None or not window.steps:
        return None
    return window.timeline.seconds(PATTERN) * 1e3 / len(window.steps)
