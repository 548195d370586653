"""What the port's evaluation reads, against keds_tpu: the benchmark
datasets' samples and the transforms' arrays bit for bit, load_clip's
parameters, and KnowledgeDB.from_config's rows and names."""

import os
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from keds_tpu import tokenizer as jtok  # noqa: E402
from keds_tpu import transforms as jtf  # noqa: E402
from keds_tpu.data import datasets as jds  # noqa: E402
from keds_tpu.models import loader as jloader  # noqa: E402
from keds_tpu.retrieval.database import KnowledgeDB as JDB  # noqa: E402

from keds_tpu_torch import transforms as ttf  # noqa: E402
from keds_tpu_torch.data import datasets as tds  # noqa: E402
from keds_tpu_torch.models import loader as tloader  # noqa: E402
from keds_tpu_torch.retrieval.database import KnowledgeDB as TDB  # noqa: E402
from torch_port_helpers import (JCFG, jax_models, to_numpy, write_eval_tree,  # noqa: E402
                                write_synthetic_vocab)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaldata")
    vocab = write_synthetic_vocab(root / "merges.txt.gz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KEDS_TPU_BPE_VOCAB", vocab)
        jtok.get_tokenizer.cache_clear()
        jtok.star_token_id.cache_clear()
        try:
            yield write_eval_tree(root)
        finally:
            jtok.get_tokenizer.cache_clear()
            jtok.star_token_id.cache_clear()


def _same(a, b):
    """Equal samples: arrays bit for bit (dtype included), the rest by ==."""
    if isinstance(a, tuple):
        return isinstance(b, tuple) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def _datasets(ds, tf, root, normalize):
    t = tf.image_transform(32, normalize=normalize)
    pad = tf.image_transform(32, target_pad=1.25, normalize=normalize)
    region = tf.region_transform(32, normalize=normalize)
    lists = [os.path.join(root, "imgnet", f) for f in ("imgnet_real_query.txt",
                                                       "imgnet_targets.txt")]
    return {
        "cirr": ds.CIRR(transforms=t, root=root),
        "cirr_imgs": ds.CIRR(transforms=pad, root=root, mode="imgs"),
        "cirr_test": ds.CIRR(transforms=t, root=root, test=True),
        "cirr_test_imgs": ds.CIRR(transforms=t, root=root, mode="imgs", test=True),
        "fashion": ds.FashionIQ(cloth="dress", transforms=t, root=root,
                                is_return_target_path=True),
        "fashion_plain": ds.FashionIQ(cloth="dress", transforms=t, root=root),
        "fashion_imgs": ds.FashionIQ(cloth="dress", transforms=pad, root=root, mode="imgs"),
        "coco": ds.CsvCOCO(transforms=t, transforms_region=region, root=root),
        "imgnet": ds.ImageList(lists[0], root=root, transforms=t, is_labels=True),
        "imgnet_names": ds.ImageList(lists[1], root=root, transforms=t, is_labels=True,
                                     return_filename=True),
    }


@pytest.mark.parametrize("normalize", [True, False], ids=["f32", "u8"])
@pytest.mark.parametrize("name", ["cirr", "cirr_imgs", "cirr_test", "cirr_test_imgs",
                                  "fashion", "fashion_plain", "fashion_imgs", "coco",
                                  "imgnet", "imgnet_names"])
def test_dataset_samples_equal_jax(data, name, normalize):
    jset = _datasets(jds, jtf, data, normalize)[name]
    tset = _datasets(tds, ttf, data, normalize)[name]
    assert len(tset) == len(jset) > 0
    for i in (0, len(jset) - 1):
        assert _same(tset[i], jset[i]), (name, i)


@pytest.mark.parametrize("size", [(40, 48), (48, 40), (90, 30), (30, 90), (32, 32)])
@pytest.mark.parametrize("normalize", [True, False], ids=["f32", "u8"])
def test_transforms_equal_jax(size, normalize):
    rng = np.random.default_rng(size[0])
    img = Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8))
    for target_pad in (None, 1.25):
        a = ttf.image_transform(24, target_pad=target_pad, normalize=normalize)(img)
        b = jtf.image_transform(24, target_pad=target_pad, normalize=normalize)(img)
        assert _same(a, b) and a.shape == (24, 24, 3)
    assert _same(ttf.region_transform(24, normalize)(img), jtf.region_transform(24, normalize)(img))
    assert ttf.TargetPad(1.25)(img).size == jtf.TargetPad(1.25)(img).size
    # the host-normalised array equals the uint8 one normalised on the device
    u8 = ttf.image_transform(24, normalize=False)(img)
    f = ttf.image_transform(24)(img)
    np.testing.assert_allclose(ttf.device_normalize(torch.from_numpy(u8)).numpy(), f,
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("normalize", [False, True])
def test_train_transform_waits_for_the_train_crop(normalize):
    """The train crop (ported now; the name is kept) equals JAX's under one
    seeded random.Random each: the same draws in the same order, up to the
    centre-crop fallback of a sliver the ten draws cannot fit."""
    rng = np.random.default_rng(7)
    imgs = [Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))
            for h, w in ((40, 40), (37, 61), (90, 24), (33, 33), (200, 3))]
    tr, jr = random.Random(11), random.Random(11)
    t = ttf.image_transform(32, is_train=True, rng=tr, normalize=normalize)
    j = jtf.image_transform(32, is_train=True, rng=jr, normalize=normalize)
    for img in imgs * 3:
        assert _same(t(img), j(img))
    assert tr.getstate() == jr.getstate()
    pad_t = ttf.image_transform(32, is_train=True, target_pad=1.25, rng=tr)
    pad_j = jtf.image_transform(32, is_train=True, target_pad=1.25, rng=jr)
    assert _same(pad_t(imgs[2]), pad_j(imgs[2]))


@pytest.mark.parametrize("layout", ["state_dict", "train_checkpoint"])
def test_load_clip_equals_jax(tmp_path, layout):
    from keds_tpu.models.convert import clip_pytree_to_state_dict

    params, _ = jax_models()
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          clip_pytree_to_state_dict(to_numpy(params), JCFG).items()}
    path = tmp_path / "clip.pt"
    torch.save(sd if layout == "state_dict" else {"epoch": 3, "state_dict": sd}, path)
    tp, tcfg, t_train, t_val = tloader.load_clip(str(path), device="cpu")
    jp, jcfg, _, j_val = jloader.load_clip(str(path))
    assert dataclasses_equal(tcfg, jcfg)
    for (kp, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(to_numpy(jp))[0],
                               jax.tree_util.tree_flatten_with_path(
                                   jax.tree.map(lambda t: t.numpy(), tp))[0]):
        np.testing.assert_array_equal(b, a, err_msg=str(kp))
    img = Image.new("RGB", (50, 40), (10, 200, 30))
    assert _same(t_val(img), j_val(img))
    with pytest.raises(FileNotFoundError, match="no cached file at .*ViT-L-14.pt .*downloads "
                                                "nothing"):
        tloader.load_clip("ViT-L/14", device="cpu", download_root=str(tmp_path / "none"))


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _db_dir(tmp_path):
    rng = np.random.default_rng(4)
    d = tmp_path / "db"
    d.mkdir()
    np.save(d / "image_db.npy", rng.standard_normal((20, 8)).astype(np.float32))
    torch.save(torch.from_numpy(rng.standard_normal((20, 8)).astype(np.float32)),
               d / "cc_text_databases.pt")
    (d / "database_names.txt").write_text("\n".join(f"r{i}" for i in range(20)))
    other = tmp_path / "other"
    other.mkdir()
    np.save(other / "img.npy", rng.standard_normal((20, 8)).astype(np.float32))
    (other / "names.txt").write_text("\n".join(f"o{i}" for i in range(20)))
    return d, other


@pytest.mark.parametrize("override", ["none", "image", "names", "files_only"])
def test_knowledge_db_from_config_equals_jax(tmp_path, override):
    d, other = _db_dir(tmp_path)
    cfg = SimpleNamespace(database_path=str(d), db_image_file=None, db_text_file=None,
                          db_names_file=None)
    if override == "image":
        cfg.db_image_file = str(other / "img.npy")
    elif override == "names":
        cfg.db_names_file = str(other / "names.txt")
    elif override == "files_only":
        cfg = SimpleNamespace(database_path=None, db_image_file=str(other / "img.npy"),
                              db_text_file=str(d / "cc_text_databases.pt"),
                              db_names_file=str(other / "names.txt"))
    jdb = JDB.from_config(cfg, dtype=np.float32)
    tdb = TDB.from_config(cfg, torch.float32, "cpu")
    assert tdb.names == jdb.names
    np.testing.assert_array_equal(tdb.image_db.numpy(), np.asarray(jdb.image_db))
    np.testing.assert_array_equal(tdb.text_db.numpy(), np.asarray(jdb.text_db))


def test_knowledge_db_from_config_refuses_a_missing_db(tmp_path):
    cfg = SimpleNamespace(database_path=str(tmp_path), db_image_file=None,
                          db_text_file=None, db_names_file=None)
    with pytest.raises(FileNotFoundError, match="--database-path"):
        TDB.from_config(cfg, torch.float32, "cpu")
    with pytest.raises(FileNotFoundError, match="--database-path"):
        JDB.from_config(cfg)
