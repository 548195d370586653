"""Kernel B2 (``csrc/attention.cu``: the fused attention forward) against
its roofline, as ``b1_roofline`` reads B1's: the vision tower's attention
in its encode chunks and the text tower's at each row's real length."""

from benchmark.harness import counts

PATTERN = r"\battention_(tc|tc_stream|f32|wide|wide_tc)\b"


def calls(window):
    cfg, out = window.config, []
    for step in window.steps:
        if step.get("images"):
            out += counts.vision_b2_calls(cfg, step["images"], step["encode_chunk"])
        if step.get("text"):
            out += counts.text_b2_calls(cfg, step["text"])
    return out


def read(window):
    if window.timeline is None:
        return None
    return counts.roofline_pct(calls(window), window.timeline.seconds(PATTERN))
