"""The control of every cell comes out not correct: the program with its
lower-precision path switched on (the limits file names it: ``int8``, the
W8A8 towers), at the cell's own size with a short window, on the card.
``calibrate.py`` reads the same runs over many seeds; this keeps one seed
of each as a test."""

import json
import time

import pytest

from benchmark.harness import core

CELLS = [w["name"] for w in core.spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    control = json.loads((core.BENCH / "limits" / f"{cell}.json").read_text())["control"]
    result, checks = core.run_cell(cell, 4294967291, 2.0, False, card, time.time(),
                                   control=control)
    assert not result["correct"], {c.name: c.value for c in checks}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_at_the_cells_size_is_correct(card, cell):
    result, checks = core.run_cell(cell, 4294967279, 2.0, False, card, time.time())
    assert result["correct"], {c.name: c.value for c in checks}
