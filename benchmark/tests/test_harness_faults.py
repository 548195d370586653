"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a tiny size of the cell's configuration (the program's
plain versions), against the cell's own limits: a sound run is correct,
and each fault the cell can have makes it not correct.
"""

import time

import pytest
import torch

from benchmark.harness import core


def tiny(cell: str) -> dict:
    cfg = core.config(core.find_cell(core.spec(), cell)["config"])
    cfg.update(embed_dim=768, image_resolution=32, vision_layers=2, vision_width=64,
               vision_patch_size=16, vision_heads=1, transformer_width=64,
               transformer_heads=1, transformer_layers=2)
    cfg["heads"] = dict(cfg["heads"], im2text_middle_dim=32, crossformer_layers=2)
    cfg["db"] = dict(cfg["db"], rows=1000, dim=768, topk=4)   # scores as wide as the cell's
    return cfg


SMALL = {
    "serve_bulk": dict(batch=32, batches_per_call=2, image_pool_batches=2, check_rows=16,
                       trace_calls=1),
    "query_b32": dict(batch=32, image_pool_batches=2, gallery_rows=500, check_requests=2,
                      trace_calls=2),
    "train_raw": dict(batch=16, image_pool_batches=4, trace_calls=2),
}


def run(cell: str, fault=None, trace=False, seed=4294967311):
    entry = core.find_cell(core.spec(), cell)
    mix = dict(core.traffic(entry["traffic"]), **SMALL[entry["traffic"]])
    result, _ = core.run_cell(cell, seed, 0.3, trace, torch.device("cpu"), time.time(),
                              config_override=tiny(cell), mix_override=mix, fault=fault)
    return result


@pytest.mark.parametrize("cell", ["vitl14.serve_bulk", "vitl14.query_b32", "vitl14.train_raw"])
def test_a_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell, fault", [
    ("vitl14.serve_bulk", "half"),        # half of every batch left out
    ("vitl14.serve_bulk", "answer"),      # answers altered where they are made
    ("vitl14.serve_bulk", "neighbours"),  # the DB rows one past the right ones
    ("vitl14.query_b32", "half"),
    ("vitl14.query_b32", "answer"),
    ("vitl14.query_b32", "neighbours"),
    ("vitl14.train_raw", "state"),        # a step that leaves the heads unchanged
    ("vitl14.train_raw", "half"),         # half of the batch, the mean over the rest
    ("vitl14.train_raw", "neighbours"),
])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    assert not run(cell, fault)["correct"]


def test_a_traced_run_reports_per_layer_metrics_and_a_breakdown():
    result = run("vitl14.serve_bulk", trace=True)
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "mfu.serve" in result["metrics"]
