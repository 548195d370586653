"""The port's profiling module (keds_tpu_torch.profiling) as
tests/test_runtime_profiling.py holds keds_tpu's, and --profile-dir: the
train loop traces JAX's window (steps 10-20 of the first epoch, or from
steps_per_epoch - 2 in a shorter epoch), each step a train_step_e0 range,
and trains the same heads as without it."""

import glob
import json
import time

import pytest
import torch

from keds_tpu_torch.cli.main import main as train_main
from keds_tpu_torch.profiling import StepTimer, annotate, trace
from keds_tpu_torch.train.trainer import train_epoch
from torch_port_helpers import tiny_run_dir

torch.set_num_threads(1)


def test_step_timer():
    t = StepTimer()
    time.sleep(0.01)
    t.data_ready()
    assert t.data_time >= 0.01
    time.sleep(0.01)
    t.step_done()
    assert t.batch_time >= t.data_time


def test_trace_noop_without_dir(tmp_path):
    with trace(None):
        torch.ones(8).sum()
    with trace(""):
        pass
    assert not any(tmp_path.iterdir())


def _ranges(d, name):
    """Count of CPU ``name`` ranges in the one trace file under ``d``."""
    files = glob.glob(str(d / "*.pt.trace.json"))
    assert len(files) == 1, files
    events = json.loads(open(files[0]).read())["traceEvents"]
    return sum(e.get("name") == name and e.get("cat") == "user_annotation" for e in events)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")):
        with annotate("region"):
            torch.ones(8).sum()
    assert _ranges(tmp_path / "prof", "region") == 1


@pytest.mark.parametrize("steps,n_ranges", [(22, 11), (5, 2), (1, 1)])
def test_train_epoch_traces_the_jax_window(tmp_path, steps, n_ranges):
    """22 steps: steps 10-20 traced; 5 steps: from step 3 to the epoch's
    end, the trace still closed; 1 step: from step 0."""
    seen = []

    def step(heads, batch, t):
        seen.append(t)
        return torch.tensor(float(t))

    batches = [(torch.zeros(2, 3),)] * steps
    loss = train_epoch(step, None, iter(batches), 0, steps, profile_dir=str(tmp_path / "p"))
    assert float(loss) == steps - 1 and seen == list(range(steps))
    assert _ranges(tmp_path / "p", "train_step_e0") == n_ranges


def test_train_cli_profile_dir_traces_steps_10_to_20(tmp_path):
    """The train CLI with --profile-dir at 24 steps an epoch: one trace of
    11 train_step_e0 ranges, written for the first of two epochs only (one
    file), and the same heads as the run without it."""
    data, dbdir, clip_path = tiny_run_dir(tmp_path)
    heads = []
    for name, extra in (("plain", []), ("traced", ["--profile-dir", str(tmp_path / "prof")])):
        train_main(["--train-data", str(data), "--dataset-type", "directory",
                    "--clip-weights", str(clip_path), "--database-path", str(dbdir),
                    "--batch-size", "1", "--epochs", "2", "--lr", "1e-3", "--warmup", "2",
                    "--skip-scheduler", "--db-topk", "8", "--precision", "fp32",
                    "--logs", str(tmp_path / "logs"), "--name", name, "--device", "cpu",
                    "--seed", "3", *extra])
        heads.append(torch.load(tmp_path / "logs" / name / "checkpoints" / "epoch_2.pt",
                                weights_only=False)["state_dict_img2text"])
    assert _ranges(tmp_path / "prof", "train_step_e0") == 11
    for key, t in heads[0].items():
        torch.testing.assert_close(heads[1][key], t, atol=0, rtol=0)
