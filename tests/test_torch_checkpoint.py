"""Port train checkpoints (reference .pt layout) against keds_tpu's readers,
resume, and the train CLI end to end on the CPU."""

import json
import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keds_tpu.io.checkpoint import load_heads_checkpoint as jload_heads_checkpoint
from keds_tpu.io.checkpoint import restore_opt_state
from keds_tpu.models.convert import clip_pytree_to_state_dict
from keds_tpu.train.trainer import make_optimizer as jmake_optimizer

from keds_tpu_torch.io.checkpoint import (load_checkpoint, load_heads_checkpoint,
                                          restore_optimizer, save_train_checkpoint)
from keds_tpu_torch.models.convert import head_parameters
from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
from keds_tpu_torch.train.losses import TrainBatch
from keds_tpu_torch.train.trainer import make_optimizer, make_train_step

from torch_port_helpers import D, JCFG, TCFG, jax_models, port_models, to_numpy
from torch_port_helpers import run_cli as _cli
from torch_port_helpers import tiny_run_dir as _tiny_run_dir

torch.set_num_threads(1)
OPT = dict(lr=1e-3, beta1=0.9, beta2=0.98, eps=1e-6, wd=0.1, warmup=2)
PROMPT = np.zeros((1, 77), np.int32)
PROMPT[0, :5] = [49406, 320, 1125, 539, 49407]


def _trainer(seed=0):
    params, heads = jax_models()
    tparams, theads = port_models(params, heads)
    rng = np.random.default_rng(seed)
    db = KnowledgeDB.from_arrays(rng.standard_normal((64, D)), rng.standard_normal((64, D)),
                                 dtype=torch.float32, device="cpu")
    opt, sched = make_optimizer(SimpleNamespace(**OPT, skip_scheduler=False), 10, theads)
    step = make_train_step(tparams, TCFG, Retriever(db), opt, sched, stream="image",
                           prompt_tokens=PROMPT, split_id=265, dropout=0.1, seed=seed,
                           compute_dtype=torch.float32, device="cpu")
    return tparams, theads, opt, sched, step, db


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [TrainBatch(*(torch.from_numpy(rng.standard_normal((8, D)).astype(np.float32))
                         for _ in range(2))) for _ in range(n)]


def _trained_checkpoint(tmp_path, n_steps=2):
    tparams, theads, opt, _, step, _ = _trainer()
    for t, b in enumerate(_batches(n_steps)):
        step(theads, b, t)
    path = str(tmp_path / "epoch_1.pt")
    save_train_checkpoint(path, epoch=1, name="t", clip_params=tparams, clip_cfg=TCFG,
                          heads=theads, optimizer=opt)
    return path, theads, opt


def test_checkpoint_loads_into_jax_heads(tmp_path):
    path, theads, _ = _trained_checkpoint(tmp_path)
    jheads, epoch = jload_heads_checkpoint(path)
    assert epoch == 1
    ours = [t.detach().numpy() for t in jax.tree.leaves(theads)]
    theirs = jax.tree.leaves(to_numpy(jheads))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    ckpt = load_checkpoint(path)
    params, _ = jax_models()
    ref_sd = clip_pytree_to_state_dict(to_numpy(params), JCFG)
    assert set(ckpt["state_dict"]) == set(ref_sd)
    for k, v in ref_sd.items():
        np.testing.assert_array_equal(ckpt["state_dict"][k].numpy(), v)


def test_checkpoint_moments_restore_into_optax(tmp_path):
    path, theads, opt = _trained_checkpoint(tmp_path)
    jheads, _ = jload_heads_checkpoint(path)
    jheads = jax.tree.map(jnp.asarray, jheads)
    jopt, _ = jmake_optimizer(SimpleNamespace(**OPT, skip_scheduler=False), 10)
    state = restore_opt_state(path, jopt.init(jheads), heads=jheads)
    adam = next(s for s in state if "mu" in getattr(s, "_fields", ()))
    assert int(adam.count) == 2
    ours = [(opt.state[t]["exp_avg"], opt.state[t]["exp_avg_sq"])
            for t in jax.tree.leaves(theads)]
    for (m, v), jm, jv in zip(ours, jax.tree.leaves(adam.mu), jax.tree.leaves(adam.nu)):
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_resume_equals_uninterrupted(tmp_path):
    """2 steps + save + resume + 1 step gives the heads and moments of 3
    steps (dropout on: the generator follows the step count)."""
    batches = _batches(3)
    _, h_ref, opt_ref, _, step, _ = _trainer()
    for t, b in enumerate(batches):
        step(h_ref, b, t)
    path, _, _ = _trained_checkpoint(tmp_path)
    tparams, _, _, _, _, db = _trainer()
    heads, epoch = load_heads_checkpoint(path, "cpu")
    opt, sched = make_optimizer(SimpleNamespace(**OPT, skip_scheduler=False), 10, heads)
    assert restore_optimizer(opt, load_checkpoint(path), heads)
    step = make_train_step(tparams, TCFG, Retriever(db), opt, sched, stream="image",
                           prompt_tokens=PROMPT, split_id=265, dropout=0.1,
                           compute_dtype=torch.float32, device="cpu")
    step(heads, batches[2], 2)
    for (_, name, a), (_, _, b) in zip(head_parameters(heads), head_parameters(h_ref)):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)
        torch.testing.assert_close(opt.state[a]["exp_avg"], opt_ref.state[b]["exp_avg"],
                                   atol=0, rtol=0)


def test_cli_trains_and_resumes(tmp_path, caplog, monkeypatch):
    """Two epochs, then --resume auto to a third, equal the heads of three
    uninterrupted epochs; the checkpoints load into the JAX package.  The
    text stream and raw csv data (which tokenize with it) are refused
    without a BPE vocab."""
    data, dbdir, clip_path = _tiny_run_dir(tmp_path)
    ck_a = _cli(tmp_path, data, dbdir, clip_path, "a", 3)
    ck_b = _cli(tmp_path, data, dbdir, clip_path, "b", 2)
    assert sorted(p.name for p in ck_b.iterdir()) == ["epoch_1.pt", "epoch_2.pt"]
    with caplog.at_level(logging.INFO):
        _cli(tmp_path, data, dbdir, clip_path, "b", 3, "--resume", "auto")
    assert any("resumed from" in r.message and "epoch 2" in r.message for r in caplog.records)
    scalars = [json.loads(x) for x in (tmp_path / "logs" / "b" / "scalars.jsonl")
               .read_text().splitlines()]
    assert [s["step"] for s in scalars] == [0, 3, 6] and all(np.isfinite(s["train/loss"])
                                                             for s in scalars)
    heads_a, _ = jload_heads_checkpoint(str(ck_a / "epoch_3.pt"))
    heads_b, epoch = jload_heads_checkpoint(str(ck_b / "epoch_3.pt"))
    assert epoch == 3
    for a, b in zip(jax.tree.leaves(heads_a), jax.tree.leaves(heads_b)):
        np.testing.assert_array_equal(a, b)
    from keds_tpu_torch import tokenizer

    monkeypatch.delenv("KEDS_TPU_BPE_VOCAB", raising=False)
    monkeypatch.setattr(tokenizer, "_VOCAB_SEARCH_PATHS", ())
    with pytest.raises(SystemExit, match="BPE vocab"):
        _cli(tmp_path, data, dbdir, clip_path, "c", 1, "--stream", "text")
    with pytest.raises(SystemExit, match="raw images: CLIP BPE vocab"):
        _cli(tmp_path, data, dbdir, clip_path, "d", 1, "--dataset-type", "csv")


def test_cli_precomputed_neighbours_equal_the_search(tmp_path):
    """--neighbors auto: a pack of the exact search's rows trains the same
    heads as the in-step search; a stale pack is refused."""
    import hashlib

    from keds_tpu_torch.data.datasets import FeaturePairDataset
    from keds_tpu_torch.retrieval.database import db_fingerprint

    data, dbdir, clip_path = _tiny_run_dir(tmp_path)
    db = KnowledgeDB.from_directory(str(dbdir), torch.float32, "cpu")
    names = FeaturePairDataset(str(data)).names
    q = torch.from_numpy(np.load(data / "image_features.npy"))
    q = q / q.norm(dim=1, keepdim=True)
    retr = Retriever(db)
    packs = [retr.search(q, a, 8)[1].numpy() for a in (db.image_db, db.text_db)]
    meta = dict(db_fingerprint(db), k=8, precision="fp32", backend="cpu",
                dataset_len=len(names),
                dataset_names_sha1=hashlib.sha1("\n".join(names).encode()).hexdigest())

    def write(m):
        np.savez(data / "neighbors.npz", img_idx=packs[0], txt_idx=packs[1],
                 cap2_idx=np.zeros((len(names), 2), np.int32),
                 meta_json=np.frombuffer(json.dumps(m).encode(), np.uint8))

    write(meta)
    ck_s = _cli(tmp_path, data, dbdir, clip_path, "searched", 1)
    ck_p = _cli(tmp_path, data, dbdir, clip_path, "packed", 1, "--neighbors", "auto")
    a, b = (load_checkpoint(str(c / "epoch_1.pt")) for c in (ck_s, ck_p))
    for key in ("state_dict_img2text", "state_dict_retrieval_fuse"):
        for name, t in a[key].items():
            torch.testing.assert_close(b[key][name], t, atol=0, rtol=0)
    write(dict(meta, rows=49))
    with pytest.raises(SystemExit, match="stale"):
        _cli(tmp_path, data, dbdir, clip_path, "stale", 1, "--neighbors", "auto")
