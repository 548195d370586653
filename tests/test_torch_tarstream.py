"""The port's tar-shard stream against keds_tpu's: shard lists, member
grouping, the shuffled sample order, the decoded images (uint8 and
normalised, train-cropped from one seeded generator) and the caption tokens,
per epoch; the resampled draw, upsampling factors and their errors."""

import io
import json
import random
import tarfile

import numpy as np
import pytest
import torch

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from keds_tpu import tokenizer as jtok  # noqa: E402
from keds_tpu.data import tarstream as jts  # noqa: E402

from keds_tpu_torch import tokenizer as ttok  # noqa: E402
from keds_tpu_torch.data import tarstream as tts  # noqa: E402
from torch_port_helpers import write_synthetic_vocab  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Three shards of 7 JPEGs (40-56 px, key-named), one sample without a
    caption and one member without an extension; the caption map; a
    synthetic vocab in KEDS_TPU_BPE_VOCAB."""
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(0)
    caps = {}
    for s in range(3):
        with tarfile.open(root / f"cc-{s:05d}.tar", "w") as tf:
            for i in range(7):
                key = f"s{s}_{i}"
                buf = io.BytesIO()
                h, w = rng.integers(40, 57, 2)
                Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
                    buf, format="JPEG")
                for name, data in ((f"{key}.image_byte", buf.getvalue()),
                                   (f"{key}.txt", b"unused"), ("README", b"x")):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
                if key != "s1_3":
                    caps[key] = f"a photo of the red dog number {s} {i}"
    (root / "caps.json").write_text(json.dumps(caps))
    vocab = write_synthetic_vocab(root / "merges.txt.gz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KEDS_TPU_BPE_VOCAB", vocab)
        jtok.get_tokenizer.cache_clear()
        jtok.star_token_id.cache_clear()
        try:
            yield root, caps
        finally:
            jtok.get_tokenizer.cache_clear()
            jtok.star_token_id.cache_clear()


@pytest.mark.parametrize("pattern", ["cc-{00000..00011}.tar", "a/{x,yy,z}.tar", "b/{7..9}-c.tar",
                                     "plain.tar", "cc-{00..02}.tar::d/{1..2}.tar"])
def test_braceexpand_equals_jax(pattern):
    for part in pattern.split("::"):
        assert tts.braceexpand(part) == jts.braceexpand(part)


def test_grouping_equals_jax():
    members = [("a.jpg", b"1"), ("a.txt", b"2"), ("a.jpg", b"3"), ("b.jpg", b"4"),
               (".hidden", b"5"), ("noext", b"6"), ("dir/c.IMAGE_BYTE", b"7"),
               ("dir/c.json", b"8"), ("d.txt", b"9")]
    for name, _ in members:
        assert tts.base_plus_ext(name) == jts.base_plus_ext(name)
    assert list(tts.group_tar_samples(members)) == list(jts.group_tar_samples(members))


def _stream(mod, root, caps, *, epoch=0, normalize=False, tokenize=None, **kw):
    """(images, caption rows) of every batch of one epoch, the train crop's
    draws from the global generator seeded 0 (both packages' CLIs draw from
    it), decode in the calling thread."""
    kw.setdefault("shuffle_buffer", 5)
    ds = mod.TarShardDataset(
        str(root / "cc-{00000..00002}.tar"), batch_size=4,
        decode_image=mod.pil_jpeg_decoder(32, is_train=True, normalize=normalize),
        caption_map=caps, tokenize=tokenize, seed=3, train_num_samples=20, **kw)
    ds.set_epoch(epoch)
    random.seed(0)
    return list(ds)


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("normalize", [False, True])
def test_stream_equals_jax(shards, epoch, normalize):
    """Shard shuffle, buffer order, drops, crops, decode and the epoch
    budget (20 samples -> 5 batches of 4; 20 of the 21 samples have a
    caption) equal keds_tpu's."""
    root, caps = shards
    want = _stream(jts, root, caps, epoch=epoch, normalize=normalize)
    got = _stream(tts, root, caps, epoch=epoch, normalize=normalize)
    assert len(got) == len(want) == 5
    for (gi, gc), (wi, wc) in zip(got, want):
        assert gi.dtype == wi.dtype == (np.float32 if normalize else np.uint8)
        assert gi.shape == (4, 32, 32, 3)
        np.testing.assert_array_equal(gi, wi)
        assert list(gc) == list(wc)
    keys = [c for _, cs in got for c in cs]
    assert len(set(keys)) == 20 and caps.get("s1_3") is None


def test_tokens_equal_jax(shards):
    root, caps = shards
    want = _stream(jts, root, caps, tokenize=jtok.tokenize)
    got = _stream(tts, root, caps, tokenize=ttok.tokenize)
    for (_, gc), (_, wc) in zip(got, want):
        assert gc.dtype == wc.dtype and gc.shape == (4, 77)
        np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("factors", [None, "1::3"])
def test_resampled_draw_equals_jax(shards, factors):
    """With replacement, per (seed, epoch): two sources weighted 1 and 3."""
    root, caps = shards
    urls = str(root / "cc-{00000..00001}.tar") + "::" + str(root / "cc-00002.tar")
    runs = []
    for mod in (jts, tts):
        ds = mod.TarShardDataset(urls, batch_size=4, decode_image=mod.pil_jpeg_decoder(
            32, is_train=False, normalize=False), caption_map=caps, seed=1,
            train_num_samples=40, resampled=True, upsampling_factors=factors,
            shuffle_buffer=3)
        ds.set_epoch(2)
        runs.append(list(ds))
    assert len(runs[1]) == len(runs[0]) == 10
    for (gi, gc), (wi, wc) in zip(runs[1], runs[0]):
        np.testing.assert_array_equal(gi, wi)
        assert list(gc) == list(wc)


def test_threads_keep_the_stream_order(shards):
    """Decode on threads (val transform, no draws) gives the serial stream."""
    root, caps = shards
    out = []
    for workers in (0, 3):
        ds = tts.TarShardDataset(str(root / "cc-{00000..00002}.tar"), batch_size=4,
                                 decode_image=tts.pil_jpeg_decoder(32, is_train=False),
                                 caption_map=caps, seed=3, train_num_samples=20,
                                 workers=workers)
        out.append(list(ds))
        ds.close()
    for (a, ca), (b, cb) in zip(*out):
        np.testing.assert_array_equal(a, b)
        assert list(ca) == list(cb)


@pytest.mark.parametrize("kw,match", [
    (dict(resampled=True, upsampling_factors="1::2::3"), "has 3 entries"),
    (dict(upsampling_factors="1::2"), "requires --dataset-resampled")])
def test_upsampling_errors_equal_jax(kw, match):
    urls = "a-{0..1}.tar::b.tar"
    for mod in (jts, tts):
        with pytest.raises(ValueError, match=match):
            mod.TarShardDataset(urls, batch_size=2, decode_image=lambda b: None, **kw)


def test_caption_map_layouts(tmp_path):
    """--caption-map: a json dict, or the reference's pkl list of records."""
    import pickle

    (tmp_path / "m.json").write_text(json.dumps({"k1": "a dog"}))
    with open(tmp_path / "m.pkl", "wb") as f:
        pickle.dump([{"filename": "k1", "text": "a dog"}], f)
    assert tts.load_caption_map(str(tmp_path / "m.json")) == {"k1": "a dog"}
    assert tts.load_caption_map(str(tmp_path / "m.pkl")) == {"k1": "a dog"}
    assert tts.load_caption_map(None) == {}
