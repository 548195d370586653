"""Host ms a step inside the program's compute stages (``encode``,
``retrieve``, ``fuse``, ``text``, ``rank``, ``backward``, ``all_reduce``,
``optimizer``; a union, so the Retriever's ``retrieve`` inside the train
step's counts once): how long the host takes to issue one step's device
work.  No host synchronise falls inside a compute stage (a
``torch.cuda.set_sync_debug_mode("warn")`` run of every cell's traced
calls: the program's are the input copies and the read-backs), so no wait
for the card to finish counts here; but a host running ahead of the card
can block inside a launch call once the launch queue is full, and that
wait counts: there the value follows the card's pace."""

from benchmark.harness import program_spans as ps


def read(window):
    spans = ps.spans(window)
    if spans is None:
        return None
    ms = ps.seconds(ps.intervals(window, ps.named(spans, ps.COMPUTE))) * 1e3
    return ms / len(ps.steps(spans))
