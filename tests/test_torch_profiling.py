"""The port's profiling module (keds_tpu_torch.profiling) as
tests/test_runtime_profiling.py holds keds_tpu's, and --profile-dir: the
train loop traces JAX's window (steps 10-20 of the first epoch, or from
steps_per_epoch - 2 in a shorter epoch), each step a train_step_e0 range,
and trains the same heads as without it.  The program's spans: none
without a profile; under one, the engine's and the train step's stages in
order, nested, one step id a batch or step, on the profiler's clock."""

import glob
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from keds_tpu_torch.cli.main import main as train_main
from keds_tpu_torch.engine import ComposedQueryEngine, DeviceCorpus
from keds_tpu_torch.profiling import (SPAN_CAPACITY, SPANS, StepTimer, annotate, span,
                                      stage_spans, trace)
from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
from keds_tpu_torch.train import losses
from keds_tpu_torch.train.trainer import make_optimizer, make_train_step, train_epoch
from torch_port_helpers import (D, SPLIT_ID, TCFG, jax_models, port_models, prompt_tokens,
                                tiny_run_dir)

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


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The train CLI at 24 steps an epoch, two epochs, without and with
    --profile-dir: (the profile directory, each run's epoch-2 heads)."""
    tmp_path = tmp_path_factory.mktemp("cli")
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
    return tmp_path / "prof", heads


def test_train_cli_profile_dir_traces_steps_10_to_20(cli_runs):
    """The train CLI with --profile-dir at 24 steps an epoch: one trace of
    11 train_step_e0 ranges, written for the first of two epochs only (one
    file), and the same heads as the run without it."""
    prof, heads = cli_runs
    assert _ranges(prof, "train_step_e0") == 11
    for key, t in heads[0].items():
        torch.testing.assert_close(heads[1][key], t, atol=0, rtol=0)


def test_train_cli_profile_dir_holds_the_stage_ranges_in_each_step(cli_runs):
    """Each train_step_e0 range of the trace holds one train.step range and,
    inside it, the feature batch's stages in order (among torch's own
    ranges, such as the optimizer's)."""
    (path,) = glob.glob(str(cli_runs[0] / "*.pt.trace.json"))
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                     for e in json.loads(open(path).read())["traceEvents"]
                     if e.get("cat") == "user_annotation"), key=lambda r: (r[0], -r[1]))
    steps = [r for r in ranges if r[2] == "train_step_e0"]
    assert len(steps) == 11
    for a, b, _ in steps:
        inside = [n for s, e, n in ranges
                  if a <= s and e <= b and n in {"train.step", *TRAIN_STAGES}]
        assert inside == ["train.step", *TRAIN_STAGES[1:]], inside


# --- the program's spans -------------------------------------------------------

BATCH_STAGES = ["input", "encode", "retrieve", "fuse", "text"]
# a raw batch's train-step stages; the Retriever's retrieve nests in the step's
TRAIN_STAGES = ["encode", "retrieve", "retrieve", "fuse", "text", "backward", "optimizer"]
MARKS = ["encode", "retrieval", "heads_forward", "text_tower_forward", "backward",
         "optimizer"]
OPT = dict(lr=1e-3, beta1=0.9, beta2=0.98, eps=1e-6, wd=0.1, warmup=2, skip_scheduler=False)


@pytest.fixture(scope="module")
def engine():
    tparams, theads = port_models(*jax_models())
    rng = np.random.default_rng(0)
    img, txt = (rng.standard_normal((50, D)).astype(np.float32) for _ in range(2))
    return ComposedQueryEngine(tparams, TCFG, theads,
                               KnowledgeDB.from_arrays(img, txt, dtype=torch.float32,
                                                       device="cpu"),
                               split_id=SPLIT_ID, compute_dtype=torch.float32, db_topk=4,
                               encode_chunk=2, device="cpu")


def _queries(n, seed):
    images = np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    return images, prompt_tokens(n, 5, seed)


def _engine_calls(engine):
    """compose over two batches, then search one batch against a device corpus."""
    (a, ta), (b, tb) = _queries(3, 1), _queries(3, 2)
    corpus = DeviceCorpus(torch.nn.functional.normalize(torch.randn(20, D), dim=-1), 20)
    engine.compose([a, b], [ta, tb])
    engine.search([a], [ta], corpus, topn=5)


def _train_step(raw: bool):
    tparams, theads = port_models(*jax_models())
    rng = np.random.default_rng(3)
    tdb = KnowledgeDB.from_arrays(*(rng.standard_normal((32, D)).astype(np.float32)
                                    for _ in range(2)), dtype=torch.float32, device="cpu")
    opt, sched = make_optimizer(SimpleNamespace(**OPT), 10, theads)
    prompt = np.zeros((1, 77), np.int32)
    prompt[0, :5] = [49406, 320, 1125, 539, 49407]
    step = make_train_step(tparams, TCFG, Retriever(tdb), opt, sched, stream="image",
                           prompt_tokens=prompt, split_id=SPLIT_ID, dropout=0.0,
                           compute_dtype=torch.float32, encode_chunk=2, device="cpu")
    if raw:
        images, caps = _queries(4, 4)
        batch = losses.RawBatch(torch.from_numpy(images), torch.from_numpy(caps[:, :16]))
    else:
        batch = losses.TrainBatch(*(torch.from_numpy(rng.standard_normal((4, D)).astype(
            np.float32)) for _ in range(2)))
    return lambda mark: step(theads, batch, 0, mark=mark)


def _recorded(fn):
    """(fn's new spans in the order they opened, the profiler's events as
    (name, start ns, end ns)) of ``fn()`` under a CPU profile."""
    before = {s.id for s in SPANS}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return sorted((s for s in SPANS if s.id not in before), key=lambda s: s.id), events


def test_no_span_is_recorded_without_a_profile(engine):
    """Without a profile a span is one shared no-op context (the enabled
    flag's check), and engine calls and train steps record nothing."""
    assert span("a") is span("b", step=True)
    mark = []
    assert stage_spans(mark.append, "encode", {}) == mark.append
    before = list(SPANS)
    _engine_calls(engine)
    _train_step(raw=True)(mark.append)
    assert list(SPANS) == before and mark == MARKS
    assert SPANS.maxlen == SPAN_CAPACITY


def test_engine_spans_nest_in_order_with_one_step_id_a_batch(engine):
    spans, _ = _recorded(lambda: _engine_calls(engine))
    assert [s.name for s in spans] == (
        ["engine.compose"] + (["engine.batch"] + BATCH_STAGES) * 2 + ["fetch"]
        + ["engine.search", "engine.batch"] + BATCH_STAGES + ["rank", "fetch"])
    by_id = {s.id: s for s in spans}
    for s in spans:
        parent = by_id.get(s.parent)
        if s.name.startswith("engine.") and s.name != "engine.batch":
            assert s.parent is None and s.step is None
        elif s.name == "engine.batch":
            assert parent.name in ("engine.compose", "engine.search") and s.step == s.id
        elif s.name == "fetch":
            assert parent.name in ("engine.compose", "engine.search") and s.step is None
        else:
            assert parent.name == "engine.batch" and s.step == parent.id
        assert s.start_ns <= s.end_ns
        if parent is not None:
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    assert len({s.step for s in spans if s.step is not None}) == 3


@pytest.mark.parametrize("raw", [True, False], ids=["raw", "features"])
def test_train_step_spans_are_its_stages_at_the_mark_hook(raw):
    """The stages follow one another inside train.step, ending where the
    mark hook is called, which sees the same stages as without a profile."""
    marks, times = [], {}

    def mark(stage):
        marks.append(stage)
        times[stage] = time.time_ns()

    spans, _ = _recorded(lambda: _train_step(raw)(mark))
    stages = TRAIN_STAGES if raw else TRAIN_STAGES[1:]
    assert marks == (MARKS if raw else MARKS[1:])
    assert [s.name for s in spans] == ["train.step", *stages]
    step = spans[0]
    assert step.parent is None and step.step == step.id
    assert all(s.step == step.id for s in spans)
    outer = [s for s in spans[1:] if s.parent == step.id]
    assert [s.name for s in outer] == [n for i, n in enumerate(stages)
                                       if not (n == "retrieve" and stages[i - 1] == n)]
    inner = [s for s in spans[1:] if s.parent != step.id]
    assert [(s.name, by.name) for s in inner for by in spans if by.id == s.parent] == [
        ("retrieve", "retrieve")]
    for s, stage in zip(outer, marks):
        assert s.end_ns <= times[stage]                      # each stage ends at its mark
    for a, b in zip(outer, outer[1:]):
        assert a.end_ns <= b.start_ns


def test_spans_hold_the_profiler_records_of_their_ops(engine):
    """Each span lies inside the profiler's own record of its range and,
    but for ``input`` (a numpy batch made a CPU tensor runs no operator),
    holds the record of an operator run inside it: one clock."""
    spans, events = _recorded(lambda: (_engine_calls(engine), _train_step(True)(lambda s: 0)))
    for s in spans:
        assert any(n == s.name and a <= s.start_ns and s.end_ns <= b for n, a, b in events), s
        if s.name != "input":
            assert any(n.startswith("aten::") and s.start_ns <= a and b <= s.end_ns
                       for n, a, b in events), s


def test_a_span_left_open_is_ended_by_the_span_around_it():
    """An exception inside a stage: the step's span ends the open stage, and
    the next span opens at the top again."""
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError):
            with span("outer", step=True):
                stage_spans(lambda s: None, "stage", {})
                raise RuntimeError("fails mid-stage")
        with span("next"):
            pass
    outer, stage, nxt = (next(s for s in reversed(SPANS) if s.name == n)
                         for n in ("outer", "stage", "next"))
    assert stage.parent == outer.id and stage.end_ns <= outer.end_ns
    assert nxt.parent is None and nxt.step is None
