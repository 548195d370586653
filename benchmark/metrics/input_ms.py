"""Host ms a step (a batch or a request) inside the program's ``input``
spans: the engine putting the step's uint8 images and prompt tokens on the
device, a copy from pageable host memory that holds the host until it is
done."""

from benchmark.harness import program_spans as ps


def read(window):
    spans = ps.spans(window)
    if spans is None:
        return None
    ms = ps.seconds(ps.intervals(window, ps.named(spans, ("input",)))) * 1e3
    return ms / len(ps.steps(spans))
