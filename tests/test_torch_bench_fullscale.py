"""The port's full-scale eval benches (keds_tpu_torch.tools.bench_cirr_fullscale
and bench_coco_fullscale) at the JAX tools' tiny scale, f32 on the CPU: the
staged files equal keds_tpu's build_artifacts output for the same arguments
(arrays bit for bit, JSON and CSV text, image pixels; checkpoints key for
key and shape for shape), the JSON line carries the JAX tool's keys, and
the recall tables equal keds_tpu's eval CLI on the same workdir."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from keds_tpu import tokenizer as jtok  # noqa: E402
from keds_tpu.cli.eval_retrieval import main as jeval_main  # noqa: E402
from keds_tpu.evalkit import evaluators as jev  # noqa: E402
from keds_tpu.retrieval.database import KnowledgeDB as JKnowledgeDB  # noqa: E402
from keds_tpu.tools import bench_cirr_fullscale as jcirr  # noqa: E402
from keds_tpu.tools import bench_coco_fullscale as jcoco  # noqa: E402

from keds_tpu_torch.evalkit import evaluators as tev  # noqa: E402
from keds_tpu_torch.tools import bench_cirr_fullscale as tcirr  # noqa: E402
from keds_tpu_torch.tools import bench_coco_fullscale as tcoco  # noqa: E402
from torch_port_helpers import write_synthetic_vocab  # noqa: E402

torch.set_num_threads(1)

TOOLS = {"cirr": (tcirr, jcirr), "coco": (tcoco, jcoco)}
SIZES = {"cirr": ["--queries", "6", "--corpus", "8"], "coco": ["--rows", "8"]}
SCALE = ["--model-scale", "tiny", "--db-rows", "64", "--epochs", "2", "--image-px", "32"]
RUN = ["--batch-size", "4", "--workers", "0", "--precision", "fp32", "--device", "cpu"]
# the keys of the JAX tools' JSON lines (keds_tpu/tools/bench_*_fullscale.py)
PHASES = {"corpus_s", "queries_s", "sweep_s", "sweep_load_s", "sweep_compose_s",
          "sweep_metrics_s"}
KEYS = {"cirr": {"metric", "value", "unit", "vs_baseline", "scale", "batch_size", "precision",
                 "device_preprocess", "db_shard", "eval_ranking", "setup_s",
                 "full_ckpt_probe_s", *PHASES},
        "coco": {"metric", "value", "unit", "vs_baseline", "scale", "batch_size", "precision",
                 "eval_ranking", "setup_s", *PHASES}}


def _jax_args(workdir) -> SimpleNamespace:
    """What the JAX tools' build_artifacts and _fingerprint read, as SCALE
    and SIZES give it."""
    return SimpleNamespace(workdir=str(workdir), queries=6, corpus=8, rows=8, db_rows=64,
                           epochs=2, image_px=32, model_scale="tiny")


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """Each tool's workdir as the port stages it (--build-only) and as the
    JAX tool's build_artifacts does, with the synthetic vocab set."""
    root = tmp_path_factory.mktemp("fullscale")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KEDS_TPU_BPE_VOCAB", write_synthetic_vocab(root / "v.txt.gz"))
        jtok.get_tokenizer.cache_clear()
        jtok.star_token_id.cache_clear()
        dirs = {}
        for tool, (port, jax_tool) in TOOLS.items():
            port.main(["--workdir", str(root / f"port_{tool}"), *SCALE, *SIZES[tool],
                       "--build-only", "--device", "cpu"])
            jax_tool.build_artifacts(_jax_args(root / f"jax_{tool}"))
            dirs[tool] = (root / f"port_{tool}", root / f"jax_{tool}")
        yield dirs
    jtok.get_tokenizer.cache_clear()
    jtok.star_token_id.cache_clear()


def _files(root) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if os.path.relpath(d, root).split(os.sep)[0] != "logs")


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def _shapes(ckpt: dict) -> dict:
    return {k: ({n: tuple(t.shape) for n, t in v.items()} if k.startswith("state_dict")
                else v) for k, v in ckpt.items()}


@pytest.mark.parametrize("tool", ["cirr", "coco"])
def test_staged_files_equal_jax(staged, tool):
    port, jax_dir = staged[tool]
    files = _files(port)
    assert files == _files(jax_dir)
    # CIRR: 2 epochs in each branch; COCO: 2 x 2 in the image branch
    assert sum(f.endswith(".pt") and "branch" in f for f in files) == 4
    for rel in files:
        a, b = port / rel, jax_dir / rel
        if rel.endswith((".json", ".txt", ".csv")):
            assert a.read_text() == b.read_text(), rel
        elif rel.endswith((".png", ".jpg")):
            np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)),
                                          err_msg=rel)
        elif rel.startswith("db"):
            ta, tb = _load(a), _load(b)
            assert ta.dtype == tb.dtype == torch.float32
            assert torch.equal(ta, tb), rel
        else:
            ca, cb = _load(a), _load(b)
            if "state_dict" in ca:
                # the reference's 0-d logit_scale; keds_tpu's save_pt writes
                # it as (1,) (np.ascontiguousarray gives ndim >= 1)
                assert ca["state_dict"]["logit_scale"].shape == ()
                assert cb["state_dict"]["logit_scale"].shape == (1,)
                for c in (ca, cb):
                    c["state_dict"]["logit_scale"] = c["state_dict"]["logit_scale"].reshape(())
            assert _shapes(ca) == _shapes(cb), rel
    assert json.loads((port / "fingerprint.json").read_text()) == \
        TOOLS[tool][1]._fingerprint(_jax_args(port))


@pytest.mark.parametrize("tool", ["cirr", "coco"])
def test_jax_knowledge_db_reads_the_port_db(staged, tool):
    port, jax_dir = staged[tool]

    def load(d):
        return JKnowledgeDB.load(str(d / "db" / "cc_image_databases.pt"),
                                 str(d / "db" / "cc_text_databases.pt"),
                                 str(d / "db" / "database_names.txt"), dtype=jnp.float32)

    got, want = load(port), load(jax_dir)
    assert got.names == want.names and len(got.names) == 64
    for name in ("image_db", "text_db"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)))


def _recording(module, name, tables, epochs=None):
    """``module.<name>`` recording each table; with ``epochs`` it sweeps
    those (the JAX CLI's evaluator sweeps 1..30 or 1..25 otherwise)."""
    real = getattr(module, name)

    def run(*args, **kw):
        if epochs is not None:
            kw["epochs"] = epochs
        tables.append(real(*args, **kw))
        return tables[-1]

    return run


@pytest.mark.parametrize("tool,ranking", [("cirr", "host"), ("cirr", "device"),
                                          ("coco", "host"), ("coco", "device")])
def test_tool_prints_jax_keys_and_jax_tables(staged, tool, ranking, monkeypatch, capsys,
                                             caplog):
    import logging

    caplog.set_level(logging.INFO)
    port, _ = staged[tool]
    monkeypatch.setenv("KEDS_TPU_BPE_VOCAB", str(port.parent / "v.txt.gz"))
    name = f"evaluate_{tool}"
    tables, jax_tables = [], []
    monkeypatch.setattr(tev, name, _recording(tev, name, tables))
    TOOLS[tool][0].main(["--workdir", str(port), *SCALE, *SIZES[tool], *RUN,
                         "--eval-ranking", ranking])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == KEYS[tool]
    assert rec["metric"] == f"{tool}_fullscale_eval_wall_s"
    assert rec["scale"] == TOOLS[tool][1]._fingerprint(_jax_args(port))
    assert rec["eval_ranking"] == ranking and rec["precision"] == "fp32"
    assert rec["value"] >= rec["corpus_s"] + rec["queries_s"] + rec["sweep_s"] - 0.5
    assert f"{tool.upper()}[j=2]" in caplog.text
    assert len(tables) == 1 and {j for j, _ in tables[0]} == {1, 2}

    # keds_tpu's eval CLI on the same files (the port's argv less --device),
    # sweeping the same two epochs
    monkeypatch.setattr(jev, name, _recording(jev, name, jax_tables, epochs=[1, 2]))
    jeval_main([*tcirr.eval_argv(SimpleNamespace(workdir=str(port), batch_size=4, workers=0,
                                                 precision="fp32", eval_ranking=ranking,
                                                 device="cpu"),
                                 tool, "text_branch" if tool == "cirr" else "image_branch")
                [:-2], "--name", f"jax_{tool}_{ranking}"])
    jtok.get_tokenizer.cache_clear()
    jtok.star_token_id.cache_clear()
    assert tables == jax_tables


def test_an_explicit_sweep_reaches_the_evaluator_unchanged():
    calls = []

    def evaluate(ctx, *loaders, epochs=range(1, 31)):
        calls.append(list(epochs))

    run = tcirr.with_sweep(evaluate, 2)
    run("ctx", "queries", "targets")
    run("ctx", "queries", "targets", epochs=[5, 7])
    run("ctx", "loader", epochs=range(3, 4))
    assert calls == [[1, 2], [5, 7], [3]]


@pytest.mark.parametrize("tool", ["cirr", "coco"])
def test_second_build_only_leaves_the_fingerprint(staged, tool):
    port, _ = staged[tool]
    marker = port / "fingerprint.json"
    first = marker.stat().st_mtime_ns
    TOOLS[tool][0].main(["--workdir", str(port), *SCALE, *SIZES[tool], "--build-only",
                         "--device", "cpu"])
    assert marker.stat().st_mtime_ns == first


def test_host_preprocess_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="--no-device-preprocess: not ported, left out on "
                                         "purpose"):
        tcirr.main(["--workdir", str(tmp_path), "--no-device-preprocess", "--device", "cpu"])
    assert not os.listdir(tmp_path)
