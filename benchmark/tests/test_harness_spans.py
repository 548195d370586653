"""The readers of the program's spans (``harness/program_spans.py`` and the
``program_span`` metrics it serves) on the CPU, at the tiny sizes of
``test_harness_faults.py``: every cell's traced run reports each of its
span metrics as a finite number, the launch-bound idle share within the
device's idle share; an untraced run records no span; and the helper
refuses a window whose step spans do not match its traced steps."""

import math

import pytest
import torch

from benchmark.harness import core, program_spans, tracing
from test_harness_faults import run

SPAN_METRICS = {m["name"] for m in core.spec()["per_layer"] if m["source"] == "program_span"
                and m["name"].split(".")[0] in ("input_ms", "issue_ms", "launch_idle_pct",
                                                "launches")}


@pytest.mark.parametrize("cell, family", [("vitl14.serve_bulk", "serve"),
                                          ("vitl14.query_b32", "query"),
                                          ("vitl14.train_raw", "train")])
def test_a_traced_run_reports_every_span_metric(cell, family):
    result = run(cell, trace=True)
    assert result["correct"], result["checks"]
    want = {m["name"] for m in core.cell_metrics(core.spec(), cell, True)} & SPAN_METRICS
    assert want == {n for n in SPAN_METRICS if n.endswith("." + family)}
    got = result["metrics"]
    assert want <= set(got), set(got)
    assert all(math.isfinite(got[n]["value"]) and got[n]["value"] >= 0 for n in want)
    assert got[f"issue_ms.{family}"]["value"] > 0
    assert (got[f"launch_idle_pct.{family}"]["value"]
            <= got[f"device_idle_pct.{family}"]["value"])


def test_an_untraced_run_records_no_span():
    from keds_tpu_torch.profiling import SPANS

    before = list(SPANS)
    assert run("vitl14.query_b32")["correct"]
    assert list(SPANS) == before


def test_the_helper_takes_the_window_s_spans_and_counts_its_steps():
    """Spans outside the traced window are left out; the window's step
    spans must be one a traced step."""
    from keds_tpu_torch.profiling import span

    with span("outside", step=True):         # no profile: nothing recorded
        pass

    def body():
        for _ in range(2):
            with span("step", step=True):
                with span("encode"):
                    torch.ones(4).sum()

    _, tl = tracing.capture(body, torch.device("cpu"))
    window = core.Window([], 0.0, 0.0, timeline=tl, steps=[{}, {}])
    got = program_spans.spans(window)
    assert [s.name for s in sorted(got, key=lambda s: s.id)] == ["step", "encode"] * 2
    assert len(program_spans.steps(got)) == 2
    with pytest.raises(ValueError, match="2 step spans for 3 traced steps"):
        program_spans.spans(core.Window([], 0.0, 0.0, timeline=tl, steps=[{}] * 3))
    later = tracing.Timeline(tl.device, tl.host, (tl.window[1] + 1.0, tl.window[1] + 2.0))
    assert program_spans.spans(core.Window([], 0.0, 0.0, timeline=later, steps=[])) is None
