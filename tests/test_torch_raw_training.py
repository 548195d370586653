"""Raw-image training of the image stream (csv and webdataset) against
keds_tpu, f32 on the CPU: encode_raw_batch, whole raw train steps, the
caption buckets, both CLI modes (an epoch from the same checkpoint, then a
resume) and the CLI's refusals."""

import io
import json
import random
import tarfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from keds_tpu import tokenizer as jtok  # noqa: E402
from keds_tpu.cli.main import main as jtrain_main  # noqa: E402
from keds_tpu.config import Config as JConfig  # noqa: E402
from keds_tpu.io.checkpoint import save_train_checkpoint  # noqa: E402
from keds_tpu.retrieval.database import KnowledgeDB as JKnowledgeDB  # noqa: E402
from keds_tpu.retrieval.database import Retriever as JRetriever  # noqa: E402
from keds_tpu.train import losses as jlosses  # noqa: E402
from keds_tpu.train.trainer import make_optimizer as jmake_optimizer  # noqa: E402
from keds_tpu.train.trainer import make_train_step as jmake_train_step  # noqa: E402

from keds_tpu_torch.cli.main import main as ttrain_main  # noqa: E402
from keds_tpu_torch.io.checkpoint import load_heads_checkpoint  # noqa: E402
from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever  # noqa: E402
from keds_tpu_torch.tokenizer import bucket_text  # noqa: E402
from keds_tpu_torch.train import losses  # noqa: E402
from keds_tpu_torch.train.trainer import make_optimizer, make_train_step  # noqa: E402
from torch_port_helpers import (D, JCFG, TCFG, jax_models, port_models, prompt_tokens,  # noqa: E402
                                tiny_run_dir, to_numpy, write_synthetic_vocab)

torch.set_num_threads(1)
LR = 1e-3
OPT = dict(lr=LR, beta1=0.9, beta2=0.98, eps=1e-6, wd=0.1, warmup=2)
PROMPT = np.zeros((1, 77), np.int32)
PROMPT[0, :5] = [49406, 320, 1125, 539, 49407]   # "a photo of"


def _raw_inputs(rng, b=8, u8=True):
    images = (rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8) if u8
              else rng.standard_normal((b, 32, 32, 3)).astype(np.float32))
    return images, prompt_tokens(b, 7, seed=int(rng.integers(100)))


@pytest.mark.parametrize("u8", [True, False])
def test_encode_raw_batch_equals_jax(u8):
    """Image features (uint8 normalised on the device, or float as given)
    and caption features; captions=False leaves the caption tower out."""
    params, heads = jax_models()
    tparams, _ = port_models(params, heads)
    images, caps = _raw_inputs(np.random.default_rng(1), u8=u8)
    want = jlosses.encode_raw_batch(params, JCFG, jlosses.RawBatch(
        jnp.asarray(images), jnp.asarray(caps), jnp.zeros((8, 77), jnp.int32)), encode_chunk=4)
    batch = losses.RawBatch(torch.from_numpy(images), torch.from_numpy(caps))
    got = losses.encode_raw_batch(tparams, TCFG, batch, encode_chunk=4)
    assert got.image_features.dtype == got.caption_features.dtype == torch.float32
    assert not got.image_features.requires_grad
    np.testing.assert_allclose(got.image_features.numpy(), np.asarray(want.image_features),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.caption_features.numpy(),
                               np.asarray(want.caption_features), atol=1e-5, rtol=1e-5)
    no_caps = losses.encode_raw_batch(tparams, TCFG, batch, encode_chunk=4, captions=False)
    assert no_caps.caption_features is None
    assert torch.equal(no_caps.image_features, got.image_features)


def test_bucketed_captions_equal_full_width():
    """The CLI cuts the caption tokens to their causal-prefix bucket: the
    caption features at that width equal those at 77."""
    tparams, _ = port_models(*jax_models())
    images, caps = _raw_inputs(np.random.default_rng(2))
    cut = bucket_text(caps, n_pseudo=1)
    assert cut.shape[1] < 77
    full = losses.encode_raw_batch(tparams, TCFG, losses.RawBatch(
        torch.from_numpy(images), torch.from_numpy(caps)))
    short = losses.encode_raw_batch(tparams, TCFG, losses.RawBatch(
        torch.from_numpy(images), torch.from_numpy(cut)))
    np.testing.assert_allclose(short.caption_features.numpy(),
                               full.caption_features.numpy(), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_raw_train_steps_equal_jax(n_steps):
    """make_train_step on RawBatch on both sides: f32, dropout 0, the same
    images, captions and DB; the tolerances of test_torch_train's feature
    steps (the neighbour permutations differ, which cross-attention
    cancels)."""
    params, heads = jax_models()
    tparams, theads = port_models(params, heads)
    rng = np.random.default_rng(3)
    img, txt = (rng.standard_normal((64, D)).astype(np.float32) for _ in range(2))
    jdb = JKnowledgeDB.from_arrays(img, txt, dtype=jnp.float32)
    tdb = KnowledgeDB.from_arrays(img, txt, dtype=torch.float32, device="cpu")
    jopt, _ = jmake_optimizer(JConfig(**OPT), total_steps=10)
    jstep = jmake_train_step(params, JCFG, JRetriever(jdb), jopt, stream="image",
                             prompt_tokens=PROMPT, split_id=265, dropout=0.0,
                             compute_dtype=jnp.float32, encode_chunk=4)
    topt, sched = make_optimizer(SimpleNamespace(**OPT, skip_scheduler=False), 10, theads)
    tstep = make_train_step(tparams, TCFG, Retriever(tdb), topt, sched, stream="image",
                            prompt_tokens=PROMPT, split_id=265, dropout=0.0,
                            compute_dtype=torch.float32, encode_chunk=4, device="cpu")
    jh, js = heads, jopt.init(heads)
    marks = []
    for t in range(n_steps):
        images, caps = _raw_inputs(rng)
        jh, js, jl = jstep(jh, js, jlosses.RawBatch(jnp.asarray(images), jnp.asarray(caps),
                                                    jnp.zeros((8, 77), jnp.int32)),
                           jax.random.key(t))
        tl = tstep(theads, losses.RawBatch(torch.from_numpy(images),
                                           torch.from_numpy(bucket_text(caps, n_pseudo=1))),
                   t, mark=marks.append)
        assert float(tl) == pytest.approx(float(jl), abs=1e-5)
    assert marks[:2] == ["encode", "retrieval"]
    for a, b in zip(jax.tree.leaves(theads), jax.tree.leaves(to_numpy(jh))):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=0.05 * LR * n_steps, rtol=1e-3)


def test_raw_batches_train_the_image_stream_only():
    tparams, theads = port_models(*jax_models())
    tdb = KnowledgeDB.from_arrays(np.eye(D, dtype=np.float32), np.eye(D, dtype=np.float32),
                                  dtype=torch.float32, device="cpu")
    opt, sched = make_optimizer(SimpleNamespace(**OPT, skip_scheduler=False), 10, theads)
    step = make_train_step(tparams, TCFG, Retriever(tdb), opt, sched, stream="text",
                           prompt_tokens=PROMPT, split_id=265, device="cpu",
                           db_other_tokens=np.zeros((D, 77), np.int32))
    images, caps = _raw_inputs(np.random.default_rng(0))
    with pytest.raises(ValueError, match="image stream only"):
        step(theads, losses.RawBatch(torch.from_numpy(images), torch.from_numpy(caps)), 0)


# --- the CLI ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def raw_run(tmp_path_factory):
    """The tiny run (DB, CLIP .pt), an epoch-0 checkpoint of the JAX
    initialisers' heads, 8 JPEGs in a csv and in two tar shards with a
    caption map, and the synthetic vocab."""
    root = tmp_path_factory.mktemp("raw")
    _, dbdir, clip_path = tiny_run_dir(root)
    params, heads = jax_models()
    init = root / "init.pt"
    save_train_checkpoint(str(init), epoch=0, name="t", clip_params=params, clip_cfg=JCFG,
                          heads=heads)
    rng = np.random.default_rng(5)
    (root / "imgs").mkdir()
    rows, caps = ["filepath\ttitle"], {}
    for s in range(2):
        with tarfile.open(root / f"cc-{s:05d}.tar", "w") as tf:
            for i in range(4):
                key = f"k{s}{i}"
                buf = io.BytesIO()
                Image.fromarray(rng.integers(0, 255, (40, 44, 3), np.uint8)).save(
                    buf, format="JPEG")
                (root / "imgs" / f"{key}.jpg").write_bytes(buf.getvalue())
                info = tarfile.TarInfo(f"{key}.image_byte")
                info.size = len(buf.getvalue())
                tf.addfile(info, io.BytesIO(buf.getvalue()))
                caps[key] = f"the red dog and the cat number {s}{i}"
                rows.append(f"{root / 'imgs' / key}.jpg\t{caps[key]}")
    (root / "train.csv").write_text("\n".join(rows))
    (root / "caps.json").write_text(json.dumps(caps))
    vocab = write_synthetic_vocab(root / "merges.txt.gz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KEDS_TPU_BPE_VOCAB", vocab)
        jtok.get_tokenizer.cache_clear()
        jtok.star_token_id.cache_clear()
        try:
            yield SimpleNamespace(root=root, db=dbdir, clip=clip_path, init=init)
        finally:
            jtok.get_tokenizer.cache_clear()
            jtok.star_token_id.cache_clear()


def _mode_args(r, mode):
    if mode == "csv":
        return ["--train-data", str(r.root / "train.csv"), "--dataset-type", "csv"]
    return ["--train-data", str(r.root / "cc-{00000..00001}.tar"), "--dataset-type",
            "webdataset", "--caption-map", str(r.root / "caps.json"),
            "--train-num-samples", "8"]


def _cli(main, r, mode, name, *extra):
    random.seed(0)     # both CLIs' train crops draw from the global generator
    main([*_mode_args(r, mode), "--clip-weights", str(r.clip), "--database-path", str(r.db),
          "--batch-size", "4", "--epochs", "1", "--lr", str(LR), "--warmup", "2",
          "--precision", "fp32", "--db-topk", "4", "--droprate", "0",
          "--logs", str(r.root / "logs"), "--name", name, *extra])
    return r.root / "logs" / name


@pytest.mark.parametrize("mode", ["csv", "webdataset"])
def test_cli_raw_epoch_equals_jax_then_resumes(raw_run, mode):
    """One epoch (two steps of 4) of each CLI from the same epoch-0 heads,
    crops drawn from one seeded generator on one decode thread: the two
    epoch_1.pt hold the same heads.  The port's run then resumes to epoch 2."""
    # one JAX device: tests/conftest.py emulates eight, whose mesh would feed
    # global batches of 32
    jdir = _cli(jtrain_main, raw_run, mode, f"jax_{mode}", "--resume", str(raw_run.init),
                "--num-partitions", "1")
    tdir = _cli(ttrain_main, raw_run, mode, f"port_{mode}", "--resume", str(raw_run.init),
                "--device", "cpu")
    jheads, je = load_heads_checkpoint(str(jdir / "checkpoints" / "epoch_1.pt"), "cpu")
    theads, te = load_heads_checkpoint(str(tdir / "checkpoints" / "epoch_1.pt"), "cpu")
    assert je == te == 1
    init, _ = load_heads_checkpoint(str(raw_run.init), "cpu")
    moved = max(float((a - b).abs().max()) for a, b in zip(jax.tree.leaves(theads),
                                                          jax.tree.leaves(init)))
    assert moved > 1e-4
    for a, b in zip(jax.tree.leaves(theads), jax.tree.leaves(jheads)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=0.05 * LR * 2, rtol=1e-3)
    scalars = [json.loads(x) for x in (tdir / "scalars.jsonl").read_text().splitlines()]
    assert [s["step"] for s in scalars] == [0] and np.isfinite(scalars[0]["train/loss"])
    assert "causal-prefix bucket S=16" in (tdir / "out.log").read_text()
    _cli(ttrain_main, raw_run, mode, f"port_{mode}", "--resume", "auto", "--epochs", "2",
         "--device", "cpu")
    assert (tdir / "checkpoints" / "epoch_2.pt").is_file()
    assert "resumed from" in (tdir / "out.log").read_text()


@pytest.mark.parametrize("case,match", [
    ("neighbors", "--neighbors requires precomputed features"),
    ("text", "--stream text requires precomputed features"),
    ("auto", "cannot infer dataset type")])
def test_cli_refusals_equal_jax(raw_run, case, match):
    args = {"neighbors": [*_mode_args(raw_run, "csv"), "--neighbors", "auto"],
            "text": [*_mode_args(raw_run, "webdataset"), "--stream", "text"],
            "auto": ["--train-data", str(raw_run.root / "cc-00000.tar"),
                     "--dataset-type", "auto"]}[case]
    args += ["--clip-weights", str(raw_run.clip), "--database-path", str(raw_run.db),
             "--precision", "fp32", "--logs", str(raw_run.root / "refuse"),
             "--name", case, "--batch-size", "4"]
    messages = []
    for main in (jtrain_main, ttrain_main):
        with pytest.raises(SystemExit, match=match) as e:
            main(args + (["--device", "cpu"] if main is ttrain_main else []))
        messages.append(str(e.value))
    assert messages[0] == messages[1]
