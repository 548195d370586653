"""The port's command lines with --distributed on two gloo ranks (CPU, f32):
the text-stream train CLI with causal-prefix buckets against a one-process
run on the global batch, the eval CLI with --db-shard against keds_tpu's
CIRR tables, and the serve CLI with --db-shard against a one-process run.
Rank 0 alone writes logs, JSONL and checkpoints.

The ranks run the three CLIs once, as child processes that import no jax
(``tests/torch_dist_worker.py cli``)."""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from keds_tpu import tokenizer as jtok  # noqa: E402
from keds_tpu import transforms as jtf  # noqa: E402
from keds_tpu.data.datasets import CIRR  # noqa: E402
from keds_tpu.data.loader import DataLoader as JLoader  # noqa: E402
from keds_tpu.evalkit import evaluators as jev  # noqa: E402
from keds_tpu.retrieval.database import KnowledgeDB as JKnowledgeDB  # noqa: E402
from keds_tpu.retrieval.database import Retriever as JRetriever  # noqa: E402

from keds_tpu_torch.cli import serve as tserve  # noqa: E402
from keds_tpu_torch.cli.main import main as train_main  # noqa: E402
from keds_tpu_torch.io.checkpoint import load_heads_checkpoint  # noqa: E402
from torch_dist_worker import leaves, run_ranks  # noqa: E402
from torch_port_helpers import (JCFG, eval_db_arrays, jax_models, tiny_run_dir,  # noqa: E402
                                write_branches, write_eval_tree, write_synthetic_vocab)

torch.set_num_threads(1)
EPS = 1e-6
LONG = "the dog and the cat and the ball and the"   # 10 tokens: the S=32 bucket


def _train_argv(root, name, batch, eps):
    return ["--train-data", str(root / "features"), "--dataset-type", "directory",
            "--clip-weights", str(root / "clip.pt"), "--database-path", str(root / "db"),
            "--batch-size", str(batch), "--epochs", "1", "--lr", "1e-3", "--warmup", "2",
            "--skip-scheduler", "--db-topk", "8", "--precision", "fp32", "--stream", "text",
            "--logs", str(root / "logs"), "--name", name, "--seed", "3", "--eps", str(eps)]


def _serve_argv(root, name):
    return ["--resume", str(root / "image_branch" / "epoch_1.pt"),
            "--database-path", str(root / "evaldb"), "--target-data", str(root / "corpus"),
            "--query_file", str(root / "queries.jsonl"),
            "--demo-out", str(root / f"{name}.jsonl"), "--batch-size", "4", "--db-topk", "4",
            "--topn", "5", "--precision", "fp32", "--logs", str(root / "logs"),
            "--name", name]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_cli")
    tiny_run_dir(root)               # features (24 samples), db (50 rows), clip.pt
    names = json.loads((root / "features" / "names.json").read_text())
    other = json.loads((root / "features" / "cc_other.json").read_text())
    other.update({n: LONG for n in names[::8]})   # an S=32 template in some batches
    (root / "features" / "cc_other.json").write_text(json.dumps(other))
    write_eval_tree(root)
    write_branches(root)
    (root / "evaldb").mkdir()
    for name, a in zip(("image_db", "text_db"), eval_db_arrays(127)):   # 64 + 63 rows
        np.save(root / "evaldb" / f"{name}.npy", a.astype(np.float32))
    (root / "corpus").mkdir()
    rng = np.random.default_rng(5)
    for i in range(7):
        Image.fromarray(rng.integers(0, 255, (40, 36 + i, 3), np.uint8)).save(
            root / "corpus" / f"c{i}.png")
    (root / "queries.jsonl").write_text("\n".join(
        json.dumps({"image": str(root / "corpus" / f"c{i}.png"),
                    "text": f"a photo of * , the {w} dog"})
        for i, w in ((0, "red"), (3, "cat"), (5, "red"), (6, "hat"), (1, "ball"))) + "\n")
    (root / "eval").mkdir()
    eval_argv = ["--eval-mode", "cirr", "--resume",
                 str(root / "image_branch" / "epoch_1.pt"), "--root-data", str(root),
                 "--database-path", str(root / "evaldb"),
                 "--image-branch", str(root / "image_branch"),
                 "--text-branch", str(root / "text_branch"), "--batch-size", "4",
                 "--precision", "fp32", "--logs", str(root / "logs"), "--name", "eval_mp",
                 "--db-shard", "--eval-ranking", "device"]
    (root / "cli.json").write_text(json.dumps({
        "train": _train_argv(root, "train_mp", 4, EPS), "eval": eval_argv,
        "eval_cwd": str(root / "eval"), "serve": _serve_argv(root, "serve_mp") + ["--db-shard"]}))
    vocab = write_synthetic_vocab(root / "merges.txt.gz")
    outs = run_ranks("cli", root, timeout=240, env={"KEDS_TPU_BPE_VOCAB": vocab})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KEDS_TPU_BPE_VOCAB", vocab)
        jtok.get_tokenizer.cache_clear()
        jtok.star_token_id.cache_clear()
        try:
            yield root, outs
        finally:
            jtok.get_tokenizer.cache_clear()
            jtok.star_token_id.cache_clear()


def _buckets(text):
    return sorted({int(m) for m in re.findall(r"causal-prefix bucket S=(\d+)", text)})


def test_train_cli_two_ranks_equal_one_process_on_the_global_batch(run):
    """2 ranks of 4 rows step on the global batch of 8 with grad_scale 1/2;
    AdamW at eps on g/2 is AdamW at 2 eps on g (a power-of-two scale is
    exact), so the checkpoint equals a one-process run of 8 rows at 2 eps.
    The buckets are the global batch's on every rank."""
    root, _ = run
    train_main(_train_argv(root, "train_sp", 8, 2 * EPS) + ["--device", "cpu"])
    ck = root / "logs" / "{}" / "checkpoints" / "epoch_1.pt"
    mp, _ = load_heads_checkpoint(str(ck).format("train_mp"), "cpu")
    sp, _ = load_heads_checkpoint(str(ck).format("train_sp"), "cpu")
    for a, b in zip(leaves(mp), leaves(sp)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    ranks = [_buckets((root / f"rank{r}.log").read_text()) for r in range(2)]
    one = _buckets((root / "logs" / "train_sp" / "out.log").read_text())
    assert ranks[0] == ranks[1] == one and 77 not in one and 32 in one, (ranks, one)


def test_train_cli_rank_zero_alone_writes(run):
    root, _ = run
    log = (root / "logs" / "train_mp" / "out.log").read_text()
    assert "Rank 1 |" not in log and "mesh: 2 rank(s) over gloo" in log
    assert sorted(os.listdir(root / "logs" / "train_mp" / "checkpoints")) == ["epoch_1.pt"]
    assert "Rank 1 | " in (root / "rank1.log").read_text()


def test_eval_cli_db_shard_two_ranks_equal_jax(run):
    root, outs = run
    got = [json.loads(str(o["eval_tables"])) for o in outs]
    assert got[0] == got[1]
    img, txt = eval_db_arrays(127)
    ctx = jev.EvalContext(clip_params=jax_models()[0], cfg=JCFG,
                          retriever=JRetriever(JKnowledgeDB.from_arrays(img, txt,
                                                                        dtype=jnp.float32)),
                          image_branch=str(root / "image_branch"),
                          text_branch=str(root / "text_branch"), compute_dtype=jnp.float32,
                          eval_ranking="device")
    t_val = jtf.image_transform(32, normalize=False)
    want = jev.evaluate_cirr(ctx, JLoader(CIRR(transforms=t_val, root=str(root)), 4),
                             JLoader(CIRR(transforms=t_val, root=str(root), mode="imgs"), 4),
                             epochs=[1, 2])
    assert got[0] == {f"{j}/{key}": m for (j, key), m in want.items()}
    assert not os.listdir(root / "eval")           # cirr writes nothing in the cwd
    assert "Rank 1 |" not in (root / "logs" / "eval_mp" / "out.log").read_text()


def test_serve_cli_db_shard_two_ranks_equal_one_process(run, monkeypatch):
    """The corpus ranked on the device, split over the ranks (and the DB):
    rank 0 alone writes a JSONL equal to one process's."""
    root, _ = run
    monkeypatch.setattr(tserve, "DEVICE_RANK_MIN_ROWS", 1)
    tserve.main(_serve_argv(root, "serve_sp") + ["--device", "cpu"])
    mp, sp = ([json.loads(x) for x in (root / f"{n}.jsonl").read_text().splitlines()]
              for n in ("serve_mp", "serve_sp"))
    assert len(mp) == len(sp) == 5
    for a, b in zip(mp, sp):
        assert (a["query"], a["text"]) == (b["query"], b["text"])
        assert [r["name"] for r in a["results"]] == [r["name"] for r in b["results"]]
        np.testing.assert_allclose([r["score"] for r in a["results"]],
                                   [r["score"] for r in b["results"]], rtol=0, atol=1e-5)
    assert "Rank 1 |" not in (root / "logs" / "serve_mp" / "out.log").read_text()
    printed = str(root / "serve_mp.jsonl")      # the CLI prints its output path
    assert printed in (root / "rank0.log").read_text().splitlines()
    assert printed not in (root / "rank1.log").read_text().splitlines()
