"""The port's feature-extraction tool (python -m
keds_tpu_torch.tools.extract_features) against keds_tpu's on the same
7-image folder (a ragged last batch of 3 behind the two-deep window), the
same train checkpoint and the synthetic BPE vocab, both in bf16 on the
CPU: names.json equal, the arrays within the JAX tool's own test tolerance
(rtol = atol = 2e-2, tests/test_data_tools.py), each row closest to its own
JAX row."""

import json
import pickle

import numpy as np
import pytest
import torch

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from keds_tpu import tokenizer as jtok  # noqa: E402
from keds_tpu.io.checkpoint import save_train_checkpoint  # noqa: E402
from keds_tpu.tools.extract_features import main as jextract  # noqa: E402

from keds_tpu_torch.tools.extract_features import main as textract  # noqa: E402
from torch_port_helpers import JCFG, jax_models, write_synthetic_vocab  # noqa: E402

torch.set_num_threads(1)
N = 7
TOL = 2e-2


@pytest.fixture
def tree(tmp_path, monkeypatch):
    monkeypatch.setenv("KEDS_TPU_BPE_VOCAB", write_synthetic_vocab(tmp_path / "v.txt.gz"))
    jtok.get_tokenizer.cache_clear()
    jtok.star_token_id.cache_clear()
    params, heads = jax_models()
    weights = tmp_path / "clip.pt"
    save_train_checkpoint(str(weights), epoch=1, name="t", clip_params=params, clip_cfg=JCFG,
                          heads=heads)
    rng = np.random.default_rng(0)
    images = tmp_path / "imgs"
    images.mkdir()
    for i in range(N):
        Image.fromarray(rng.integers(0, 255, (40, 44, 3), np.uint8)).save(
            images / f"img{i}.png")
    caps = {f"img{i}": f"a photo the dog number {i}" for i in range(N)}
    (tmp_path / "caps.json").write_text(json.dumps(caps))
    yield tmp_path, images, weights
    jtok.get_tokenizer.cache_clear()
    jtok.star_token_id.cache_clear()


def _run(tool, root, images, weights, name, captions="caps.json", *extra):
    out = root / name
    tool(["--images", str(images), "--captions", str(root / captions),
          "--clip-weights", str(weights), "--out", str(out), "--batch-size", "4",
          "--workers", "2", *extra])
    return (np.load(out / "image_features.npy"), np.load(out / "text_features.npy"),
            json.loads((out / "names.json").read_text()))


def _row_aligned(got, want):
    g = got / np.linalg.norm(got, axis=1, keepdims=True)
    w = want / np.linalg.norm(want, axis=1, keepdims=True)
    return bool((np.argmax(g @ w.T, axis=1) == np.arange(len(got))).all())


def test_extract_features_equals_jax(tree):
    root, images, weights = tree
    t_img, t_txt, t_names = _run(textract, root, images, weights, "port", "caps.json",
                                 "--device", "cpu")
    j_img, j_txt, j_names = _run(jextract, root, images, weights, "jax")
    assert t_names == j_names == [f"img{i}" for i in range(N)]
    assert t_img.shape == t_txt.shape == (N, JCFG.embed_dim) and t_img.dtype == np.float32
    np.testing.assert_allclose(t_img, j_img, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t_txt, j_txt, rtol=TOL, atol=TOL)
    assert _row_aligned(t_img, j_img) and _row_aligned(t_txt, j_txt)


def test_extract_features_pkl_captions_and_float16(tree):
    """The .pkl caption list and --dtype float16 give the json run's rows."""
    root, images, weights = tree
    caps = json.loads((root / "caps.json").read_text())
    with open(root / "caps.pkl", "wb") as f:
        pickle.dump([{"filename": k, "text": v} for k, v in caps.items()], f)
    f32 = _run(textract, root, images, weights, "f32", "caps.json", "--device", "cpu")
    f16 = _run(textract, root, images, weights, "f16", "caps.pkl", "--device", "cpu",
               "--dtype", "float16")
    assert f16[0].dtype == np.float16 and f16[2] == f32[2]
    np.testing.assert_array_equal(f16[0], f32[0].astype(np.float16))
    np.testing.assert_array_equal(f16[1], f32[1].astype(np.float16))


def test_extract_features_refuses_host_normalisation(tree):
    root, images, weights = tree
    with pytest.raises(SystemExit, match="left out on purpose"):
        _run(textract, root, images, weights, "x", "caps.json", "--device", "cpu",
             "--no-device-preprocess")
