"""Kernel B1 (``csrc/topk.cu``: the exact top-k search) against its
roofline: the least time the traced steps' searches could take (each the
larger of its bytes over 3.35 TB/s and its operations over the dtype's
peak, counted from the shapes sent, harness/counts.py) over the device time
of B1's kernels."""

from benchmark.harness import counts

PATTERN = r"\btopk_(tc|select|score_f32|score_bf16|fused)\b"


def calls(window):
    return [counts.b1_call(*s) for step in window.steps for s in step.get("searches", ())]


def read(window):
    if window.timeline is None:
        return None
    return counts.roofline_pct(calls(window), window.timeline.seconds(PATTERN))
