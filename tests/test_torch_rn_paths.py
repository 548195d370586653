"""An RN (ModifiedResNet) checkpoint through the port's entry points against
keds_tpu's, f32 on the CPU: the composed-query engine's search, one
features-mode epoch of the train CLI (IM2TEXT embed_dim -> --middle_dim x
--n-layer -> transformer_width, CrossFormers at transformer_width), the
CIRR eval CLI's tables; and the train parser's flag surface against
keds_tpu.config's."""

import argparse
import functools
import json
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import keds_tpu.engine as jengine
from keds_tpu import config as jconfig, tokenizer as jtok, transforms as jtf
from keds_tpu.cli.main import main as jtrain_main
from keds_tpu.data.datasets import CIRR
from keds_tpu.data.loader import DataLoader
from keds_tpu.evalkit import evaluators as jev
from keds_tpu.io.checkpoint import save_train_checkpoint
from keds_tpu.models import clip as jclip, heads as jheads
from keds_tpu.models.composition import FusionHeads as JFusionHeads
from keds_tpu.models.convert import clip_state_dict_to_pytree
from keds_tpu.retrieval.database import KnowledgeDB as JKnowledgeDB, Retriever as JRetriever

from keds_tpu_torch import config as tconfig
from keds_tpu_torch.cli.eval_retrieval import main as eval_main
from keds_tpu_torch.cli.main import main as ttrain_main
from keds_tpu_torch.engine import ComposedQueryEngine
from keds_tpu_torch.evalkit import evaluators as tev
from keds_tpu_torch.io.checkpoint import load_heads_checkpoint
from keds_tpu_torch.models.convert import heads_from_numpy
from keds_tpu_torch.models.loader import load_clip
from keds_tpu_torch.retrieval.database import KnowledgeDB
from keds_tpu_torch.train.trainer import truncated_prompt

from torch_port_helpers import (SPLIT_ID, prompt_tokens, rn_state_dict, save_state_dict,
                                to_numpy, write_eval_tree, write_synthetic_vocab)

torch.set_num_threads(1)
EMB, TW, PX = 32, 64, 64          # embed_dim != transformer_width, as in every RN model
LR = 1e-3


@functools.lru_cache()
def _rn():
    sd = rn_state_dict((1, 1, 1, 1), 8, PX, embed_dim=EMB, text_width=TW)
    params, cfg = clip_state_dict_to_pytree(sd)
    return sd, jax.tree.map(jnp.asarray, params), cfg


def _jax_heads(seed, middle=48, n_layer=2):
    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    return JFusionHeads(
        img2text=jheads.init_im2text(k1, EMB, middle, TW, n_layer=n_layer),
        retrieval_fuse=jheads.init_crossformer(k2, TW, TW, TW, num_layers=3),
        text_condition=jheads.init_crossformer(k3, TW, TW, TW, num_layers=3))


def _u8(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, PX, PX, 3), dtype=np.uint8)


def _db(rows, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((rows, EMB)).astype(np.float32) for _ in range(2))


@pytest.fixture
def vocab(tmp_path, monkeypatch):
    monkeypatch.setenv("KEDS_TPU_BPE_VOCAB", write_synthetic_vocab(tmp_path / "v.txt.gz"))
    jtok.get_tokenizer.cache_clear()
    jtok.star_token_id.cache_clear()
    yield
    jtok.get_tokenizer.cache_clear()
    jtok.star_token_id.cache_clear()


# --- serving -------------------------------------------------------------------


def test_rn_checkpoint_searches_as_jax(tmp_path, monkeypatch):
    """load_clip of an RN .pt, then ComposedQueryEngine: the corpus, the
    scores and the top-5 equal keds_tpu's engine on the same weights."""
    sd, jparams, jcfg = _rn()
    tparams, tcfg, _, t_val = load_clip(save_state_dict(sd, tmp_path / "rn.pt"), device="cpu")
    assert not tcfg.is_vit and tcfg.image_resolution == PX
    heads = _jax_heads(1)
    img, txt = _db(200)
    monkeypatch.setattr(jengine, "star_token_id", lambda: SPLIT_ID)
    je = jengine.ComposedQueryEngine(jparams, jcfg, heads,
                                     JKnowledgeDB.from_arrays(img, txt, dtype=jnp.float32),
                                     compute_dtype=jnp.float32, db_topk=8, encode_chunk=2)
    te = ComposedQueryEngine(tparams, tcfg, heads_from_numpy(to_numpy(heads), device="cpu"),
                             KnowledgeDB.from_arrays(img, txt, dtype=torch.float32,
                                                     device="cpu"),
                             split_id=SPLIT_ID, compute_dtype=torch.float32, db_topk=8,
                             encode_chunk=2, device="cpu")
    batches = [_u8(6, 7), _u8(6, 8)]
    corpus = te.encode_corpus(batches)
    assert corpus.shape == (12, EMB)
    np.testing.assert_allclose(corpus, je.encode_corpus(batches), atol=1e-4)
    ims, txs = [_u8(4, 9)], [prompt_tokens(4, 14, seed=10)]
    ref_s, ref_i = je.search(ims, txs, corpus, topn=5)
    s, i = te.search(ims, txs, te.corpus_to_device(corpus), topn=5)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, atol=1e-4)


# --- the train CLI --------------------------------------------------------------


@pytest.fixture(scope="module")
def rn_run(tmp_path_factory):
    """Packed features and a DB of width embed_dim, the RN .pt, and an
    epoch-0 checkpoint of keds_tpu's heads at --middle_dim 32 --n-layer 3."""
    root = tmp_path_factory.mktemp("rn")
    sd, jparams, jcfg = _rn()
    rng = np.random.default_rng(0)
    data, db = root / "features", root / "db"
    data.mkdir()
    db.mkdir()
    img = rng.standard_normal((24, EMB)).astype(np.float32)
    np.save(data / "image_features.npy", img)
    np.save(data / "text_features.npy",
            (img + 0.3 * rng.standard_normal((24, EMB))).astype(np.float32))
    (data / "names.json").write_text(json.dumps([f"s{i}" for i in range(24)]))
    for name, a in zip(("image_db", "text_db"), _db(50, 1)):
        np.save(db / f"{name}.npy", a)
    (db / "database_names.txt").write_text("\n".join(f"r{i}" for i in range(50)))
    init = root / "init.pt"
    save_train_checkpoint(str(init), epoch=0, name="t", clip_params=jparams, clip_cfg=jcfg,
                          heads=_jax_heads(3, middle=32, n_layer=3))
    return SimpleNamespace(root=root, data=data, db=db, init=init,
                           clip=save_state_dict(sd, root / "rn.pt"))


def _train(main, r, name, *extra):
    main(["--train-data", str(r.data), "--dataset-type", "directory", "--clip-weights", r.clip,
          "--database-path", str(r.db), "--batch-size", "8", "--epochs", "1", "--lr", str(LR),
          "--warmup", "2", "--db-topk", "8", "--precision", "fp32", "--droprate", "0",
          "--middle_dim", "32", "--n-layer", "3", "--seed", "3",
          "--logs", str(r.root / "logs"), "--name", name, *extra])
    return load_heads_checkpoint(str(r.root / "logs" / name / "checkpoints" / "epoch_1.pt"),
                                 "cpu")[0]


def _port_extra():
    """The port's image stream on features takes the prompt and '*' as
    arguments: JAX's tokenization of "a photo of" (SOT to EOT, unpadded)."""
    row = jtok.tokenize("a photo of")[0]
    prompt = row[:int(np.argmax(row == 49407)) + 1]
    return ["--device", "cpu", "--prompt-tokens", ",".join(map(str, prompt)),
            "--split-id", str(jtok.star_token_id())]


def test_train_cli_builds_jax_head_shapes_and_trains_as_jax(rn_run, vocab):
    """Fresh heads: the port's shapes are JAX's (IM2TEXT 32 -> 32 x 3 -> 64,
    CrossFormers at 64).  From the same epoch-0 heads, one epoch of each CLI
    gives the same heads (test_torch_train.py's tolerance)."""
    jfresh = _train(jtrain_main, rn_run, "jax_fresh", "--num-partitions", "1")
    tfresh = _train(ttrain_main, rn_run, "port_fresh", "--copy-codebase", *_port_extra())
    assert (rn_run.root / "logs" / "port_fresh" / "code" / "keds_tpu_torch" /
            "models" / "resnet.py").is_file()
    shapes = [tuple(a.shape) for a in jax.tree.leaves(jfresh)]
    assert [tuple(a.shape) for a in jax.tree.leaves(tfresh)] == shapes
    assert len(tfresh.img2text["layers"]) == 3
    assert tfresh.img2text["layers"][0]["w"].shape == (EMB, 32)
    assert tfresh.img2text["fc_out"]["w"].shape == (32, TW)
    assert tfresh.retrieval_fuse[0]["to_q"]["w"].shape == (TW, 512)
    jheads_ = _train(jtrain_main, rn_run, "jax", "--num-partitions", "1",
                     "--resume", str(rn_run.init))
    theads_ = _train(ttrain_main, rn_run, "port", "--resume", str(rn_run.init),
                     *_port_extra())
    init = jax.tree.leaves(load_heads_checkpoint(str(rn_run.init), "cpu")[0])
    assert max(float((a - b).abs().max()) for a, b in
               zip(jax.tree.leaves(theads_), init)) > 1e-4
    for a, b in zip(jax.tree.leaves(theads_), jax.tree.leaves(jheads_)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=0.05 * LR * 3, rtol=1e-3)


def test_unpadded_prompt_pools_at_eot():
    """--prompt-tokens gives SOT..EOT without padding: the step's prompt is
    the 77-wide tokenization's first 8 tokens, so the splice keeps EOT."""
    prompt = [49406, 320, 1125, 539, 49407]
    padded = np.zeros((1, 77), np.int64)
    padded[0, :5] = prompt
    short = truncated_prompt(np.asarray([prompt]), 49407)
    np.testing.assert_array_equal(short, truncated_prompt(padded, 49407))
    assert short.shape == (1, 8)


def test_train_cli_without_weights_refuses_rn_as_jax(tmp_path):
    with pytest.raises(KeyError) as want:
        jclip.model_config_for("RN50")
    with pytest.raises(KeyError) as got:
        ttrain_main(["--train-data", str(tmp_path), "--dataset-type", "directory",
                     "--database-path", str(tmp_path), "--model", "RN50", "--device", "cpu",
                     "--logs", str(tmp_path / "logs"), "--name", "rn"])
    assert str(got.value) == str(want.value)


# --- the eval CLI ---------------------------------------------------------------


def test_eval_cli_cirr_with_an_rn_checkpoint_equals_jax(tmp_path, monkeypatch, vocab):
    sd, jparams, jcfg = _rn()
    data = write_eval_tree(tmp_path)
    branches = [str(tmp_path / b) for b in ("image_branch", "text_branch")]
    for b, branch in enumerate(branches):
        for epoch in (1, 2):
            save_train_checkpoint(os.path.join(branch, f"epoch_{epoch}.pt"), epoch=epoch,
                                  name="t", clip_params=jparams, clip_cfg=jcfg,
                                  heads=_jax_heads(10 * (b + 1) + epoch))
    img, txt = _db(128, 2)
    (tmp_path / "db").mkdir()
    np.save(tmp_path / "db" / "image_db.npy", img)
    np.save(tmp_path / "db" / "text_db.npy", txt)
    monkeypatch.chdir(tmp_path)
    tables = []
    real = tev.evaluate_cirr

    def two_epochs(ctx, src, tgt, epochs=None):
        tables.append(real(ctx, src, tgt, epochs=[1, 2]))
        return tables[-1]

    monkeypatch.setattr(tev, "evaluate_cirr", two_epochs)
    eval_main(["--eval-mode", "cirr", "--resume", os.path.join(branches[0], "epoch_1.pt"),
               "--root-data", data, "--database-path", str(tmp_path / "db"),
               "--image-branch", branches[0], "--text-branch", branches[1],
               "--batch-size", "4", "--precision", "fp32", "--device", "cpu",
               "--logs", "logs", "--name", "eval_rn"])
    ctx = jev.EvalContext(clip_params=jparams, cfg=jcfg,
                          retriever=JRetriever(JKnowledgeDB.from_arrays(img, txt,
                                                                        dtype=jnp.float32)),
                          image_branch=branches[0], text_branch=branches[1],
                          compute_dtype=jnp.float32)
    t_val = jtf.image_transform(PX, normalize=False)     # the CLI's uint8 wire
    want = jev.evaluate_cirr(ctx, DataLoader(CIRR(transforms=t_val, root=data), 4),
                             DataLoader(CIRR(transforms=t_val, root=data, mode="imgs"), 4),
                             epochs=[1, 2])
    assert tables == [want]


# --- the parser -----------------------------------------------------------------

# the flags the port refuses: left out on purpose
REFUSED = {("--checkpoint-format", "orbax"), ("--no-device-preprocess", None)}


def _parser(add):
    p = argparse.ArgumentParser()
    add(p)
    return {opt: a for a in p._actions for opt in a.option_strings if opt != "-h"
            and opt != "--help"}


def _values(action):
    """One command line per value a flag can take but its default."""
    if action.nargs == 0:
        return [None]
    if action.choices:
        return [c for c in action.choices if c != action.default]
    if action.type is int:
        return ["3"]
    if action.type is float:
        return ["0.5"]
    return ["0,1"] if action.dest == "multigpu" else ["x"]


def test_parser_takes_every_jax_flag_or_refuses_it_with_its_item():
    jflags, tflags = _parser(jconfig._add_flags), _parser(tconfig._add_flags)
    refused = set()
    for opt, ja in jflags.items():
        ta = tflags[opt]
        assert (ta.dest, ta.default, ta.nargs) == (ja.dest, ja.default, ja.nargs), opt
        assert (ta.choices or None) == (ja.choices or None), opt
        for value in _values(ja):
            argv = [opt] + ([] if value is None else [value])
            want = getattr(jconfig.parse_args(argv), ja.dest)
            try:
                cfg = tconfig.parse_args(argv)
            except SystemExit as e:
                assert re.search(r"item 1[0-9]|left out on purpose", str(e)), (argv, e)
                refused.add((opt, value))
                continue
            assert getattr(cfg, ta.dest) == want, argv
    assert refused == REFUSED
    cfg = tconfig.parse_args(["--model", "RN50x4", "--middle_dim", "32", "--n-layer", "3",
                              "--skip-aggregate"])
    assert (cfg.middle_dim, cfg.n_layer, cfg.aggregate) == (32, 3, False)
    assert (cfg.lr, cfg.beta2, cfg.eps) == (5.0e-4, 0.999, 1.0e-8)   # the RN defaults
