"""The port's CLI plumbing against keds_tpu's: params.txt, the rank prefix
applied once, idempotent handlers, pad_batch, experiment_name, JSONL
scalars, the new flags' defaults and the refusal of unported flags."""

import logging
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from keds_tpu import logging_utils as jlog
from keds_tpu.cli import common as jcommon
from keds_tpu.config import parse_args as jparse_args

from keds_tpu_torch import logging_utils as tlog
from keds_tpu_torch.cli import common as tcommon
from keds_tpu_torch.config import parse_args as tparse_args

torch.set_num_threads(1)


@pytest.fixture
def clean_root():
    yield
    tlog.close_logging()
    jlog.setup_logging()            # replaces its own handlers ...
    root = logging.getLogger()
    for h in [h for h in root.handlers if getattr(h, "_keds_handler", False)]:
        root.removeHandler(h)       # ... which go too
        h.close()


def test_dump_params_equals_jax(tmp_path, clean_root):
    cfg = SimpleNamespace(zeta=1, alpha="a b", beta=None, gamma=[1, 2], delta=0.5)
    tlog.dump_params(cfg, str(tmp_path / "t" / "params.txt"))
    jlog.dump_params(cfg, str(tmp_path / "j" / "params.txt"))
    text = (tmp_path / "t" / "params.txt").read_text()
    assert text == (tmp_path / "j" / "params.txt").read_text()
    assert text.splitlines()[0] == "alpha: a b"


def _strip_time(text):
    return re.sub(r"^\S+ \| ", "", text, flags=re.M)


@pytest.mark.parametrize("rank", [0, 2])
def test_rank_prefix_applied_once_as_in_jax(tmp_path, clean_root, rank):
    logs = {}
    for name, mod in (("j", jlog), ("t", tlog)):
        path = tmp_path / name / "out.log"
        mod.setup_logging(str(path), rank=rank)
        mod.setup_logging(str(path), rank=rank)      # idempotent: one pair of handlers
        logging.info("hello %d", 7)
        logging.debug("hidden")
        ours = [h for h in logging.getLogger().handlers if getattr(h, "_keds_handler", False)]
        assert len(ours) == 2
        logs[name] = _strip_time(path.read_text())
    assert logs["t"] == logs["j"] == f"INFO | {'Rank 2 | ' if rank else ''}hello 7\n"


def test_pad_batch_equals_jax():
    a = np.arange(12).reshape(3, 4)
    for n in (1, 3, 5):
        np.testing.assert_array_equal(tcommon.pad_batch(a, n), jcommon.pad_batch(a, n))
    assert tcommon.pad_batch(a, 5).shape == (5, 4)
    assert (tcommon.pad_batch(a, 5)[3:] == a[-1]).all()


def test_experiment_name():
    for argv in (["--name", "run/a"], ["--name", "x", "--lr", "1e-3"]):
        assert tcommon.experiment_name(tparse_args(argv)) == jcommon.experiment_name(
            jparse_args(argv))
    for argv in (["--no-time-suffix", "--batch-size", "8"],
                 ["--no-time-suffix", "--skip-aggregate", "--model", "RN50"]):
        assert tcommon.experiment_name(tparse_args(argv)) == jcommon.experiment_name(
            jparse_args(argv))
    name = tcommon.experiment_name(tparse_args(["--no-time-suffix", "--batch-size", "8"]))
    assert name == "lr=0.0005_wd=0.2_agg=True_model=ViT-L-14_batchsize=8_workers=1"
    assert re.fullmatch(r".*_date=\d{4}(-\d\d){5}",
                        tcommon.experiment_name(tparse_args([])))


def test_setup_experiment_writes_params_and_refuses_a_used_name(tmp_path, clean_root):
    cfg = tparse_args(["--logs", str(tmp_path), "--name", "r", "--debug"])
    with tcommon.run_logging(cfg) as log_dir:
        logging.debug("a debug line")
        assert logging.getLogger().level == logging.DEBUG
    params = (tmp_path / "r" / "params.txt").read_text().splitlines()
    assert params == [f"{k}: {v}" for k, v in sorted(vars(cfg).items())]
    assert "a debug line" in (tmp_path / "r" / "out.log").read_text()
    assert not any(getattr(h, "_keds_handler", False) for h in logging.getLogger().handlers)
    with pytest.raises(SystemExit, match="already exists"):
        tcommon.setup_experiment(tparse_args(["--logs", str(tmp_path), "--name", "r"]))
    assert log_dir == str(tmp_path / "r")


def test_scalar_writers_jsonl_equals_jax(tmp_path, clean_root, caplog):
    jcfg = jparse_args(["--logs", str(tmp_path), "--name", "j"])
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jw = jcommon.ScalarWriters(jcfg)
    tw = tcommon.ScalarWriters(tparse_args(["--report-to", "tensorboard"]), str(tmp_path / "t"))
    for step, loss in ((0, 1.5), (10, 1.25)):
        for w in (jw, tw):
            w({"train/loss": loss, "train/lr": 1e-4}, step)
    tw.close()
    jw._jsonl.close()
    assert (tmp_path / "t" / "scalars.jsonl").read_text() == (
        tmp_path / "j" / "scalars.jsonl").read_text()
    # TensorBoard when it imports; a warning, not a failure, when it does not
    assert (tmp_path / "t" / "tensorboard").is_dir() or "tensorboard unavailable" in caplog.text


NEW_FLAGS = ("val_data", "dataset_type_val", "csv_separator", "csv_img_key",
             "csv_caption_key", "train_num_samples", "dataset_resampled", "caption_map",
             "train_data_upsampling_factors", "prompts", "retrieval_data", "demo_out",
             "query_file", "topn", "target_data", "report_to", "wandb_notes", "debug",
             "db_shard", "quant_towers", "worker_processes", "distributed")


def test_new_flags_parse_as_in_jax():
    argv = ["--csv-separator", ",", "--csv-img-key", "p", "--csv-caption-key", "c",
            "--train-num-samples", "96", "--dataset-resampled", "--caption-map", "m.json",
            "--train-data-upsampling-factors", "1::2", "--prompts", "a *,b *",
            "--retrieval-data", "coco", "--demo-out", "o", "--query_file", "q.jsonl",
            "--topn", "300", "--target-data", "t", "--report-to", "all", "--debug",
            "--val-data", "v.csv", "--dataset-type-val", "csv"]
    for args in ([], argv):
        t, j = tparse_args(args), jparse_args(args)
        assert {f: getattr(t, f) for f in NEW_FLAGS} == {f: getattr(j, f) for f in NEW_FLAGS}


@pytest.mark.parametrize("argv,item", [(["--checkpoint-format", "orbax"], "item 16"),
                                       (["--no-device-preprocess"], "left out on purpose")])
def test_unported_flags_are_refused(argv, item):
    with pytest.raises(SystemExit, match=item):
        tparse_args(argv)


@pytest.mark.parametrize("argv", [["--profile-dir", "x"], ["--pre-save-feature"],
                                  ["--openai-pretrained"]])
def test_item16_flags_parse_as_in_jax(argv):
    """--profile-dir, --pre-save-feature and --openai-pretrained are ported:
    they parse to the JAX package's values (the train CLI then traces,
    exits naming the port's extract_features, or reads ~/.cache/clip)."""
    fields = ("profile_dir", "pre_save_feature", "openai_pretrained")
    t, j = tparse_args(argv), jparse_args(argv)
    assert {f: getattr(t, f) for f in fields} == {f: getattr(j, f) for f in fields}


@pytest.mark.parametrize("argv", [["--quant-towers", "int8"], ["--retrieval-backend", "approx"],
                                  ["--retrieval-backend", "int8"]])
def test_int8_and_approx_flags_parse_as_in_jax(argv):
    """--quant-towers int8 and --retrieval-backend int8|approx are ported
    (ROADMAP items 14 and 15): they parse to the JAX package's values."""
    fields = ("quant_towers", "retrieval_backend")
    t, j = tparse_args(argv), jparse_args(argv)
    assert {f: getattr(t, f) for f in fields} == {f: getattr(j, f) for f in fields}


@pytest.mark.parametrize("argv", [["--db-shard"], ["--worker-processes"],
                                  ["--distributed", "--dist-url", "tcp://127.0.0.1:6200",
                                   "--num-partitions", "2"]])
def test_multi_process_flags_parse_as_in_jax(argv):
    """--distributed, --db-shard and --worker-processes are ported: they parse
    to the JAX package's values and are no longer refused."""
    fields = ("db_shard", "worker_processes", "distributed", "dist_url", "num_partitions")
    t, j = tparse_args(argv), jparse_args(argv)
    assert {f: getattr(t, f) for f in fields} == {f: getattr(j, f) for f in fields}


def test_compute_dtype():
    assert tcommon.compute_dtype(tparse_args(["--precision", "fp32"])) == torch.float32
    for p in ("amp", "fp16", "bf16"):
        assert tcommon.compute_dtype(tparse_args(["--precision", p])) == torch.bfloat16
