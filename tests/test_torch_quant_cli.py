"""The CLIs with the int8 serving modes (ROADMAP items 14 and 15) against
keds_tpu's, f32 on the CPU: the serve, eval (CIRR tables) and demo CLIs with
``--quant-towers int8 --retrieval-backend int8``, one train-CLI epoch with
``--retrieval-backend int8``, ``--neighbors`` with int8 or approx refused as
JAX refuses it, ``build_database --int8`` and a ``quant_accuracy --quick``
run with JAX's keys.

Under int8 towers an activation at a rounding boundary of its token's int8
grid may round one step the other way in the two packages (their f32 sums
run in another order), so scores and features are held to QUANT_TOL, and
names whose scores lie within QUANT_TOL of each other may swap.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from keds_tpu import tokenizer as jtok  # noqa: E402
from keds_tpu import transforms as jtf  # noqa: E402
from keds_tpu.cli import demo as jdemo, serve as jserve  # noqa: E402
from keds_tpu.cli.main import main as jtrain_main  # noqa: E402
from keds_tpu.data.datasets import CIRR  # noqa: E402
from keds_tpu.data.loader import DataLoader  # noqa: E402
from keds_tpu.evalkit import evaluators as jev  # noqa: E402
from keds_tpu.io.checkpoint import load_heads_checkpoint as jload_heads  # noqa: E402
from keds_tpu.io.checkpoint import save_train_checkpoint  # noqa: E402
from keds_tpu.retrieval.database import KnowledgeDB as JKnowledgeDB  # noqa: E402
from keds_tpu.retrieval.database import Retriever as JRetriever  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from keds_tpu_torch.cli import demo as tdemo, serve as tserve  # noqa: E402
from keds_tpu_torch.cli.eval_retrieval import main as eval_main  # noqa: E402
from keds_tpu_torch.cli.main import main as ttrain_main  # noqa: E402
from keds_tpu_torch.evalkit import evaluators as tev  # noqa: E402
from keds_tpu_torch.io.checkpoint import load_heads_checkpoint  # noqa: E402
from torch_port_helpers import (D, JCFG, eval_db_arrays, jax_models, tiny_run_dir,  # noqa: E402
                                write_branches, write_eval_tree, write_synthetic_vocab)

torch.set_num_threads(1)
QUANT_TOL = 2e-3
INT8 = ("--quant-towers", "int8", "--retrieval-backend", "int8")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = write_synthetic_vocab(tmp_path_factory.mktemp("vocab") / "merges.txt.gz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KEDS_TPU_BPE_VOCAB", path)
        jtok.get_tokenizer.cache_clear()
        jtok.star_token_id.cache_clear()
        try:
            yield path
        finally:
            jtok.get_tokenizer.cache_clear()
            jtok.star_token_id.cache_clear()


# --- serve ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_run(tmp_path_factory, vocab):
    root = tmp_path_factory.mktemp("serve_int8")
    params, heads = jax_models()
    save_train_checkpoint(str(root / "ckpt.pt"), epoch=1, name="t", clip_params=params,
                          clip_cfg=JCFG, heads=heads)
    rng = np.random.default_rng(0)
    (root / "db").mkdir()
    np.save(root / "db" / "image_db.npy", rng.standard_normal((64, D)).astype(np.float32))
    np.save(root / "db" / "text_db.npy", rng.standard_normal((64, D)).astype(np.float32))
    (root / "db" / "database_names.txt").write_text("\n".join(f"n{i}" for i in range(64)))
    (root / "corpus").mkdir()
    for i in range(11):
        Image.fromarray(rng.integers(0, 255, (40, 36 + i % 9, 3), np.uint8)).save(
            root / "corpus" / f"c{i:03d}.png")
    qimgs = [str(root / "corpus" / f"c{i:03d}.png") for i in (0, 4, 7)]
    (root / "queries.jsonl").write_text("\n".join(
        json.dumps({"image": q, "text": f"a photo of * , the {w} dog"})
        for q in qimgs for w in ("red", "cat")) + "\n")
    return root


def _serve(mod, root, name, extra=()):
    out = root / f"{name}.jsonl"
    mod.main(["--resume", str(root / "ckpt.pt"), "--database-path", str(root / "db"),
              "--target-data", str(root / "corpus"),
              "--query_file", str(root / "queries.jsonl"), "--demo-out", str(out),
              "--batch-size", "4", "--db-topk", "4", "--topn", "8", "--precision", "fp32",
              "--logs", str(root / "logs"), "--name", name, "--workers", "1", *extra])
    return [json.loads(line) for line in out.read_text().splitlines()]


@pytest.mark.parametrize("flags", [INT8, ("--retrieval-backend", "approx"),
                                   ("--quant-towers", "int8")],
                         ids=["int8_both", "approx", "int8_towers"])
def test_serve_cli_with_int8_modes_equals_jax(serve_run, flags):
    tag = "_".join(flags[1::2])
    want = _serve(jserve, serve_run, "jax_" + tag, flags)
    got = _serve(tserve, serve_run, "port_" + tag, (*flags, "--device", "cpu"))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        gn, wn = [r["name"] for r in g["results"]], [r["name"] for r in w["results"]]
        gs, ws = (np.array([r["score"] for r in x["results"]]) for x in (g, w))
        np.testing.assert_allclose(gs, ws, atol=QUANT_TOL, rtol=0)
        for r in np.nonzero(np.array(gn) != np.array(wn))[0]:
            j = wn.index(gn[r]) if gn[r] in wn else len(wn) - 1
            assert abs(ws[j] - ws[r]) <= QUANT_TOL, (r, gn[r], wn[r])


# --- eval ----------------------------------------------------------------------

def test_eval_cli_cirr_with_int8_modes_equals_jax(tmp_path, monkeypatch, vocab):
    data = write_eval_tree(tmp_path)
    branches = write_branches(tmp_path, epochs=(1, 2))
    db = tmp_path / "db"
    db.mkdir()
    img, txt = eval_db_arrays()
    np.save(db / "image_db.npy", img.astype(np.float32))
    np.save(db / "text_db.npy", txt.astype(np.float32))
    monkeypatch.chdir(tmp_path)
    tables, real = [], tev.evaluate_cirr

    def two_epochs(ctx, src, tgt, epochs=None):
        assert ctx.retriever.backend == "int8"
        assert ctx.clip_c["text"]["blocks"]["fc_w"]["q"].dtype == torch.int8
        tables.append(real(ctx, src, tgt, epochs=[1, 2]))
        return tables[-1]

    monkeypatch.setattr(tev, "evaluate_cirr", two_epochs)
    eval_main(["--eval-mode", "cirr", "--resume", os.path.join(branches[0], "epoch_1.pt"),
               "--root-data", data, "--database-path", str(db), "--image-branch",
               branches[0], "--text-branch", branches[1], "--batch-size", "4",
               "--precision", "fp32", "--device", "cpu", "--logs", "logs", "--name", "e",
               *INT8])
    ctx = jev.EvalContext(clip_params=jax_models()[0], cfg=JCFG,
                          retriever=JRetriever(JKnowledgeDB.from_arrays(img, txt,
                                                                        dtype=jnp.float32),
                                               backend="int8"),
                          image_branch=branches[0], text_branch=branches[1],
                          compute_dtype=jnp.float32, quant_towers="int8")
    t_val = jtf.image_transform(32, normalize=False)
    want = jev.evaluate_cirr(ctx, DataLoader(CIRR(transforms=t_val, root=data), 4),
                             DataLoader(CIRR(transforms=t_val, root=data, mode="imgs"), 4),
                             epochs=[1, 2])
    assert tables == [want]


# --- demo ----------------------------------------------------------------------

def test_demo_cli_with_int8_towers_equals_jax(serve_run, tmp_path, monkeypatch):
    rows = ["filepath\ttitle"] + [f"{serve_run / 'corpus' / f'c{i:03d}.png'}\tx{i}"
                                  for i in range(11)]
    (tmp_path / "corpus.csv").write_text("\n".join(rows))
    outs = {}
    for name, mod, extra in (("jax", jdemo, ()), ("port", tdemo, ("--device", "cpu"))):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        out = mod.main(["--retrieval-data", str(tmp_path / "corpus.csv"),
                        "--query_file", str(serve_run / "corpus" / "c004.png"),
                        "--prompts", "a cartoon of *,a photo of *",
                        "--resume", str(serve_run / "ckpt.pt"), "--demo-out", str(cwd / "d"),
                        "--precision", "fp32", "--batch-size", "4", "--logs", str(cwd / "l"),
                        "--name", "demo", "--quant-towers", "int8", *extra])
        (cache,) = os.listdir(cwd / "data")
        with open(cwd / "data" / cache, "rb") as f:
            outs[name] = (out, cache, pickle.load(f))
    (_, jcache, jdata), (tout, tcache, tdata) = outs["jax"], outs["port"]
    assert tcache == jcache                   # the fingerprint carries --quant-towers
    assert tdata["path"] == jdata["path"]
    np.testing.assert_allclose(tdata["feats"], np.asarray(jdata["feats"]), atol=QUANT_TOL,
                               rtol=0)
    assert len(tout["top10"][0]) == 2


# --- train ---------------------------------------------------------------------

def test_train_cli_with_the_int8_backend_trains_as_jax(tmp_path, vocab):
    """One epoch of each CLI from the same epoch-0 heads, the in-step search
    on the int8 backend, gives the same heads (test_torch_train.py's
    tolerance)."""
    data, dbdir, clip_path = tiny_run_dir(tmp_path)
    params, heads = jax_models()
    init = tmp_path / "init.pt"
    save_train_checkpoint(str(init), epoch=0, name="t", clip_params=params, clip_cfg=JCFG,
                          heads=heads)
    lr = 1e-3
    base = ["--train-data", str(data), "--dataset-type", "directory", "--clip-weights",
            str(clip_path), "--database-path", str(dbdir), "--batch-size", "8", "--epochs",
            "1", "--lr", str(lr), "--warmup", "2", "--db-topk", "8", "--precision", "fp32",
            "--droprate", "0", "--seed", "3", "--retrieval-backend", "int8", "--resume",
            str(init), "--logs", str(tmp_path / "logs")]
    jtrain_main(base + ["--name", "jax", "--num-partitions", "1"])
    row = jtok.tokenize("a photo of")[0]
    prompt = row[:int(np.argmax(row == 49407)) + 1]
    ttrain_main(base + ["--name", "port", "--device", "cpu", "--prompt-tokens",
                        ",".join(map(str, prompt)), "--split-id", str(jtok.star_token_id())])
    ckpt = "checkpoints/epoch_1.pt"
    want = jload_heads(str(tmp_path / "logs" / "jax" / ckpt))[0]
    got = load_heads_checkpoint(str(tmp_path / "logs" / "port" / ckpt), "cpu")[0]
    init_leaves = jax.tree.leaves(load_heads_checkpoint(str(init), "cpu")[0])
    assert max(float((a - b).abs().max())
               for a, b in zip(jax.tree.leaves(got), init_leaves)) > 1e-4
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=0.05 * lr * 3, rtol=1e-3)


@pytest.mark.parametrize("backend", ["int8", "approx", "pallas"])
def test_neighbors_with_another_backend_is_refused_as_jax(tmp_path, backend):
    argv = ["--train-data", str(tmp_path), "--dataset-type", "directory", "--database-path",
            str(tmp_path), "--neighbors", "auto", "--retrieval-backend", backend,
            "--logs", str(tmp_path / "logs")]
    with pytest.raises(SystemExit) as want:
        jtrain_main(argv + ["--name", "j"])
    with pytest.raises(SystemExit) as got:
        ttrain_main(argv + ["--name", "t", "--device", "cpu"])
    assert "--neighbors replaces the in-step search" in str(got.value)
    assert f"--retrieval-backend {backend}" in str(got.value) and \
        f"--retrieval-backend {backend}" in str(want.value)


# --- tools ---------------------------------------------------------------------

def test_build_database_cli_int8_equals_jax(tmp_path):
    feats = tmp_path / "feats"
    feats.mkdir()
    rng = np.random.default_rng(1)
    np.save(feats / "image_features.npy", rng.standard_normal((40, 16)).astype(np.float32))
    np.save(feats / "text_features.npy", rng.standard_normal((40, 16)).astype(np.float32))
    (feats / "names.json").write_text(json.dumps([f"n{i}" for i in range(40)]))
    for pkg in ("keds_tpu_torch", "keds_tpu"):
        subprocess.run([sys.executable, "-m", f"{pkg}.tools.build_database", "--features",
                        str(feats), "--out", str(tmp_path / pkg), "--size", "30", "--seed",
                        "4", "--int8", "--no-pt"], check=True, cwd=REPO,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True)
    for name in ("image_db_int8.npy", "text_db_scale.npy", "image_db.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "keds_tpu_torch" / name),
                                      np.load(tmp_path / "keds_tpu" / name))


def test_quant_accuracy_quick_has_jax_keys(tmp_path):
    from keds_tpu.tools import quant_accuracy as jqa

    from keds_tpu_torch.tools import quant_accuracy as tqa

    argv = ["--quick", "--rows", "1500", "--queries", "16", "--spreads", "0.35",
            "--corpus-rows", "128", "--parts", "retrieval", "towers", "pipeline"]
    out = subprocess.run([sys.executable, "-m", "keds_tpu_torch.tools.quant_accuracy",
                          *argv, "--device", "cpu"], check=True, cwd=REPO,
                         capture_output=True, text=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(got) == {"retrieval", "towers", "pipeline"}
    assert set(got["retrieval"]) == {"gaussian", "correlated s=0.35"}
    # the JAX tool's keys of each part, read from a run of its retrieval part
    want = jqa.bench_retrieval_backends(jqa.argparse.Namespace(
        rows=1500, dim=768, queries=16, k=16, spreads=[0.35]))
    assert {t: set(r) for t, r in got["retrieval"].items()} == \
        {t: set(r) for t, r in want.items()}
    for tag, row in got["retrieval"].items():
        assert row["approx"] == 1.0                     # exact off the TPU
        assert row["approx"] == want[tag]["approx"]
        assert row["int8_raw"] == want[tag]["int8_raw"]
    assert set(got["towers"]) == {"plain", "outlier"}
    assert all(set(r) == {"cos_mean", "cos_min", "nbr_overlap"} for r in got["towers"].values())
    assert set(got["pipeline"]) == {"approx", "int8_db", "int8_towers", "int8_both"}
    assert all(set(r) == {"top1_agree", "top10_overlap"} for r in got["pipeline"].values())
    assert got["pipeline"]["approx"] == {"top1_agree": 1.0, "top10_overlap": 1.0}
    assert tqa.QUICK_CFG["embed_dim"] == 64
