"""The port's eval CLI (python -m keds_tpu_torch.cli.eval_retrieval) on the
tiny CIRR trees, f32 on the CPU: its CIRR tables equal keds_tpu's
evaluate_cirr on the same files, and its res_cirr/*.json equal keds_tpu's
evaluate_cirr_test dicts."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

pytest.importorskip("PIL")

from keds_tpu import tokenizer as jtok  # noqa: E402
from keds_tpu import transforms as jtf  # noqa: E402
from keds_tpu.data.datasets import CIRR  # noqa: E402
from keds_tpu.data.loader import DataLoader  # noqa: E402
from keds_tpu.evalkit import evaluators as jev  # noqa: E402
from keds_tpu.retrieval.database import KnowledgeDB, Retriever  # noqa: E402

from keds_tpu_torch.cli.eval_retrieval import main as eval_main  # noqa: E402
from keds_tpu_torch.evalkit import evaluators as tev  # noqa: E402
from torch_port_helpers import (JCFG, eval_db_arrays, jax_models, write_branches,  # noqa: E402
                                write_eval_tree, write_synthetic_vocab)

torch.set_num_threads(1)


@pytest.fixture
def run(tmp_path, monkeypatch):
    """Data tree, branches at the CIRR test's epochs 10 and 13 as well, a
    .npy DB directory, the vocab; the CLI's working directory is tmp_path."""
    monkeypatch.setenv("KEDS_TPU_BPE_VOCAB", write_synthetic_vocab(tmp_path / "v.txt.gz"))
    jtok.get_tokenizer.cache_clear()
    jtok.star_token_id.cache_clear()
    data = write_eval_tree(tmp_path)
    branches = write_branches(tmp_path, epochs=(1, 2, 10, 13))
    db = tmp_path / "db"
    db.mkdir()
    for name, a in zip(("image_db", "text_db"), eval_db_arrays()):
        np.save(db / f"{name}.npy", a.astype(np.float32))
    monkeypatch.chdir(tmp_path)
    yield data, branches, str(db)
    jtok.get_tokenizer.cache_clear()
    jtok.star_token_id.cache_clear()


def _argv(mode, data, branches, db, *extra):
    return ["--eval-mode", mode, "--resume", os.path.join(branches[0], "epoch_1.pt"),
            "--root-data", data, "--database-path", db, "--image-branch", branches[0],
            "--text-branch", branches[1], "--batch-size", "4", "--precision", "fp32",
            "--device", "cpu", "--logs", "logs", "--name", f"eval_{mode}", *extra]


def _jax_ctx(branches, ranking="host"):
    img, txt = eval_db_arrays()
    return jev.EvalContext(clip_params=jax_models()[0], cfg=JCFG,
                           retriever=Retriever(KnowledgeDB.from_arrays(img, txt,
                                                                       dtype=jnp.float32)),
                           image_branch=branches[0], text_branch=branches[1],
                           compute_dtype=jnp.float32, eval_ranking=ranking)


@pytest.mark.parametrize("ranking", ["host", "device"])
def test_eval_cli_cirr_equals_jax(run, monkeypatch, ranking):
    data, branches, db = run
    tables = []
    real = tev.evaluate_cirr

    def two_epochs(ctx, src, tgt, epochs=None):
        tables.append(real(ctx, src, tgt, epochs=[1, 2]))
        return tables[-1]

    monkeypatch.setattr(tev, "evaluate_cirr", two_epochs)
    eval_main(_argv("cirr", data, branches, db, "--eval-ranking", ranking))
    t_val = jtf.image_transform(32, normalize=False)   # the CLI's uint8 wire
    want = jev.evaluate_cirr(_jax_ctx(branches, ranking),
                             DataLoader(CIRR(transforms=t_val, root=data), 4),
                             DataLoader(CIRR(transforms=t_val, root=data, mode="imgs"), 4),
                             epochs=[1, 2])
    assert tables == [want]
    log = open(os.path.join("logs", "eval_cirr", "out.log")).read()
    assert "CIRR[j=2] Eval mixture Feature recall_R@1" in log


def test_eval_cli_cirr_test_writes_jax_submission(run):
    data, branches, db = run
    eval_main(_argv("cirr_test", data, branches, db))
    t_val = jtf.image_transform(32, normalize=False)
    want = jev.evaluate_cirr_test(
        _jax_ctx(branches), DataLoader(CIRR(transforms=t_val, root=data, test=True), 4),
        DataLoader(CIRR(transforms=t_val, root=data, mode="imgs", test=True), 4))
    for key in ("composed", "image", "text", "mixture"):
        with open(os.path.join("res_cirr", f"{key}.json")) as f:
            assert json.load(f) == want[key]


@pytest.mark.parametrize("extra,match", [
    (("--checkpoint-format", "orbax"), "item 16"),
    (("--no-device-preprocess",), "left out on purpose"),
    (("--eval-mode", "fashion"), "--source-data"),
])
def test_eval_cli_refuses_what_is_not_ported(tmp_path, extra, match):
    with pytest.raises(SystemExit, match=match):
        eval_main(["--device", "cpu", "--logs", str(tmp_path), *extra])
