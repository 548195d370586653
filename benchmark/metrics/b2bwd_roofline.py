"""Kernel B2′ (``csrc/attention_bwd.cu``: the attention backward of the
text tower in training) against its roofline, as ``b1_roofline`` reads B1's."""

from benchmark.harness import counts

PATTERN = r"\battention_bwd_\w+"


def calls(window):
    return [c for step in window.steps if step.get("backward") and step.get("text")
            for c in counts.text_b2bwd_calls(window.config, step["text"])]


def read(window):
    if window.timeline is None:
        return None
    return counts.roofline_pct(calls(window), window.timeline.seconds(PATTERN))
