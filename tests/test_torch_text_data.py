"""Port text-stream data and tools vs keds_tpu on the CPU: the dataset's
templates on both layouts, the loader's 4- and 7-tuples, the neighbour
templates, the port's neighbour-pack tool, the train CLI with --stream
text, and its checkpoint read by keds_tpu."""

import json
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keds_tpu import tokenizer as jtok
from keds_tpu.data.datasets import FeaturePairDataset as JFeaturePairDataset
from keds_tpu.data.datasets import build_other_tokens as jbuild_other_tokens
from keds_tpu.data.loader import DataLoader as JDataLoader
from keds_tpu.io.checkpoint import load_heads_checkpoint as jload_heads_checkpoint
from keds_tpu.io.checkpoint import restore_opt_state
from keds_tpu.io.pt import save_pt
from keds_tpu.tools import precompute_neighbors as jtool
from keds_tpu.train.trainer import make_optimizer as jmake_optimizer

from keds_tpu_torch import synth
from keds_tpu_torch.data.datasets import FeaturePairDataset, build_other_tokens
from keds_tpu_torch.data.loader import DataLoader
from keds_tpu_torch.io.checkpoint import load_checkpoint, load_heads_checkpoint, restore_optimizer
from keds_tpu_torch.models.convert import head_parameters
from keds_tpu_torch.tools import precompute_neighbors as ttool
from keds_tpu_torch.train.trainer import make_optimizer

from torch_port_helpers import D, run_cli, tiny_run_dir, to_numpy
from torch_port_helpers import write_synthetic_vocab

torch.set_num_threads(1)


@pytest.fixture
def vocab(tmp_path, monkeypatch):
    """The synthetic merges file as KEDS_TPU_BPE_VOCAB for both packages.
    The JAX package caches its tokenizer per vocab argument (None here), so
    its caches are cleared before (a vocab found earlier would stay) and
    after (later tests must not see this one)."""
    path = write_synthetic_vocab(tmp_path / "merges.txt.gz")
    monkeypatch.setenv("KEDS_TPU_BPE_VOCAB", path)
    jtok.get_tokenizer.cache_clear()
    jtok.star_token_id.cache_clear()
    yield path
    jtok.get_tokenizer.cache_clear()
    jtok.star_token_id.cache_clear()


@pytest.fixture
def run(tmp_path):
    return tiny_run_dir(tmp_path)


def _per_file_copy(data, dest):
    """The packed features of ``data`` in the reference per-file layout."""
    names = json.loads((data / "names.json").read_text())
    for sub, arr in (("cc_image_feature_folder_clipl", "image_features.npy"),
                     ("cc_text_feature_folder_clipl", "text_features.npy")):
        (dest / sub).mkdir(parents=True)
        for name, row in zip(names, np.load(data / arr)):
            save_pt(row, str(dest / sub / f"{name}.pt"))
    for f in ("cc_other.json", "cc_subject.json"):
        (dest / f).write_text((data / f).read_text())
    return dest


@pytest.mark.parametrize("layout", ["packed", "per-file"])
def test_dataset_templates_match_jax(vocab, run, tmp_path, layout):
    data = run[0] if layout == "packed" else _per_file_copy(run[0], tmp_path / "perfile")
    ours = FeaturePairDataset(str(data), templates=True)
    ref = JFeaturePairDataset(str(data))
    assert ours.mode == ref.mode == layout and ours.names == ref.names
    nb = tuple(np.arange(len(ours) * w, dtype=np.int64).reshape(len(ours), w)
               for w in (16, 16, 2))
    for ds in (ours, ref):
        ds.attach_neighbors(nb)
    for i in (0, 5, 23):
        a, b = ours[i], ref[i]
        assert len(a) == len(b) == 7 and a[2] == b[2] == "a dog"
        for x, y in zip(a[:2], b[:2]):
            assert x.dtype == np.float32
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a[3], b[3])
        assert a[3][4:7].tolist() == [265] * 3
        for x, y in zip(a[4:], b[4:]):
            np.testing.assert_array_equal(x, y)
    plain = FeaturePairDataset(str(data))     # the image stream reads no vocab
    assert len(plain[3]) == 2 and plain.other == {}


def test_loader_collates_four_and_seven_tuples_as_jax(vocab, run):
    data = str(run[0])
    for attach in (False, True):
        ours = FeaturePairDataset(data, templates=True)
        ref = JFeaturePairDataset(data)
        if attach:
            nb = tuple(np.arange(len(ours) * w).reshape(len(ours), w) for w in (8, 8, 2))
            ours.attach_neighbors(nb)
            ref.attach_neighbors(nb)
        got = list(DataLoader(ours, 5, shuffle=True, seed=2, drop_last=True, num_workers=2))
        want = list(JDataLoader(ref, 5, shuffle=True, seed=2, drop_last=True))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert len(g) == len(w) == (7 if attach else 4)
            assert g[2] == w[2] and isinstance(g[2], list)
            for i in (0, 1, 3) + ((4, 5, 6) if attach else ()):
                assert g[i].shape[0] == 5
                np.testing.assert_array_equal(g[i], w[i])


def test_build_other_tokens_matches_jax(vocab):
    names = ["r0.jpg", "r1", "r2"]
    other = {"r0": "a dog * chasing", "r1": "the cat"}
    np.testing.assert_array_equal(build_other_tokens(names, other),
                                  jbuild_other_tokens(names, other))
    with pytest.raises(ValueError, match="cc_other.json"):
        build_other_tokens(names, {"x": "y"})


def test_port_tool_matches_jax_tool(run, tmp_path):
    data, dbdir, _ = run
    args = ["--train-data", str(data), "--database-path", str(dbdir), "--db-topk", "8",
            "--batch", "10", "--precision", "fp32"]
    jtool.main(args + ["--out", str(tmp_path / "jax.npz")])
    ttool.main(args + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    *ref, ref_meta = jtool.load_neighbors(str(tmp_path / "jax.npz"))
    *ours, meta = ttool.load_neighbors(str(tmp_path / "port.npz"))
    for a, b in zip(ours, ref):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert [a.shape for a in ours] == [(24, 8), (24, 8), (24, 2)]
    assert meta.pop("backend") == "cpu"
    ref_meta.pop("backend")
    assert meta == ref_meta
    assert not list(tmp_path.glob("*.tmp.npz"))


def test_cli_text_stream_trains_caches_and_refuses(vocab, run, tmp_path, caplog):
    """One epoch of --stream text: a checkpoint, the template cache with its
    fingerprint (rebuilt when the DB changes), one log line per bucket; a
    --split-id that disagrees with the vocab is refused."""
    data, dbdir, clip_path = run
    with caplog.at_level(logging.INFO):
        ck = run_cli(tmp_path, data, dbdir, clip_path, "t", 1, "--stream", "text")
    assert (ck / "epoch_1.pt").is_file()
    cache, meta_path = data / "db_other_tokens.npy", data / "db_other_tokens.npy.meta.json"
    other = json.loads((data / "cc_other.json").read_text())
    names = (dbdir / "database_names.txt").read_text().split("\n")
    np.testing.assert_array_equal(np.load(cache), jbuild_other_tokens(names, other,
                                                                      "a photo of * * "))
    meta = json.loads(meta_path.read_text())
    assert meta["template_prefix"] == "a photo of * * " and meta["rows"] == 50
    assert any("causal-prefix bucket S=16" in r.message for r in caplog.records)
    np.save(dbdir / "image_db.npy", np.random.default_rng(9).standard_normal((50, D))
            .astype(np.float32))
    caplog.clear()
    with caplog.at_level(logging.INFO):
        run_cli(tmp_path, data, dbdir, clip_path, "t2", 1, "--stream", "text")
    assert any("stale" in r.message for r in caplog.records)
    assert json.loads(meta_path.read_text())["db_rows_sha1"] != meta["db_rows_sha1"]
    with pytest.raises(SystemExit, match="disagrees"):
        run_cli(tmp_path, data, dbdir, clip_path, "t3", 1, "--stream", "text",
                "--split-id", "300")


def test_cli_text_stream_with_port_pack_equals_the_search(vocab, run, tmp_path):
    """--neighbors auto with the port tool's pack trains the in-step
    search's heads bit for bit; a pack without cap2_idx is refused."""
    data, dbdir, clip_path = run
    ttool.main(["--train-data", str(data), "--database-path", str(dbdir), "--db-topk", "8",
                "--precision", "fp32", "--device", "cpu"])
    ck_s = run_cli(tmp_path, data, dbdir, clip_path, "searched", 1, "--stream", "text")
    ck_p = run_cli(tmp_path, data, dbdir, clip_path, "packed", 1, "--stream", "text",
                   "--neighbors", "auto")
    a, b = (load_checkpoint(str(c / "epoch_1.pt")) for c in (ck_s, ck_p))
    for key in ("state_dict_img2text", "state_dict_retrieval_fuse",
                "state_dict_text_condition"):
        for name, t in a[key].items():
            torch.testing.assert_close(b[key][name], t, atol=0, rtol=0)
    with np.load(data / "neighbors.npz") as z:
        np.savez(data / "neighbors.npz", **{k: z[k] for k in z.files if k != "cap2_idx"})
    with pytest.raises(SystemExit, match="cap2_idx"):
        run_cli(tmp_path, data, dbdir, clip_path, "nocap", 1, "--stream", "text",
                "--neighbors", "auto")


def test_text_stream_checkpoint_round_trips_and_resumes_in_jax(vocab, run, tmp_path):
    """The text stream's checkpoint has no AdamW state for text_condition
    (never updated, as in the reference); the port restores it as such and
    keds_tpu's restore_opt_state resumes from it with zero moments there."""
    data, dbdir, clip_path = run
    path = str(run_cli(tmp_path, data, dbdir, clip_path, "t", 1, "--stream", "text")
               / "epoch_1.pt")
    ckpt = load_checkpoint(path)
    heads, epoch = load_heads_checkpoint(path, "cpu", ckpt)
    params = head_parameters(heads)
    stateless = [i for i, (mod, _, _) in enumerate(params) if mod == "text_condition"]
    opt, _ = make_optimizer(_opt_cfg(), 10, heads)
    assert restore_optimizer(opt, ckpt, heads)
    assert epoch == 1 and all(t not in opt.state for mod, _, t in params
                              if mod == "text_condition")
    assert all(t in opt.state for mod, _, t in params if mod != "text_condition")
    assert len(ckpt["optimizer"]["state"]) == len(params) - len(stateless)
    init = synth.init_heads(D, 512, D, 2, seed=4, device=torch.device("cpu"),
                            dtype=torch.float32)   # the CLI's at --seed 3
    jheads, jepoch = jload_heads_checkpoint(path)
    assert jepoch == 1
    for a, b in zip(jax.tree.leaves(to_numpy(jheads.text_condition)),
                    jax.tree.leaves(init.text_condition)):
        np.testing.assert_array_equal(a, b.numpy())
    jheads = jax.tree.map(jnp.asarray, jheads)
    jopt, _ = jmake_optimizer(_opt_cfg(), 10)
    state = restore_opt_state(path, jopt.init(jheads), heads=jheads)
    adam = next(s for s in state if "mu" in getattr(s, "_fields", ()))
    assert int(adam.count) == 3
    assert not any(np.any(np.asarray(m)) for m in jax.tree.leaves(adam.mu.text_condition))
    ours = [opt.state[t]["exp_avg"].numpy() for t in jax.tree.leaves(heads.img2text)]
    for m, jm in zip(ours, jax.tree.leaves(adam.mu.img2text)):
        np.testing.assert_array_equal(m, np.asarray(jm))


def _opt_cfg():
    from types import SimpleNamespace

    return SimpleNamespace(lr=1e-3, beta1=0.9, beta2=0.98, eps=1e-6, wd=0.1, warmup=2,
                           skip_scheduler=True)
