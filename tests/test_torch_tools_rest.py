"""The port's small tools and ImageNet datasets against keds_tpu's, exact:
the caption subject/other splitter (and its --workers pool), the ImageNet
val reorganiser, ImageFolderByClass and the 50-per-class subset."""

import json
import os

import numpy as np
import pytest
import torch

from keds_tpu.data import datasets as jds
from keds_tpu.tools import extract_nouns as jnouns, prep_imagenet_val as jprep

from keds_tpu_torch.data import datasets as tds
from keds_tpu_torch.tools import extract_nouns as tnouns, prep_imagenet_val as tprep

torch.set_num_threads(1)

CAPTIONS = ["a small dog in the park", "the woman wearing a red coat", "Dogs", "",
            "An old man's hat on the table", "three cats sitting by the window",
            "a well-known café near the river", "his bike and her car", "!!!",
            "the tall man wearing a hat", "A photo of a cat", "sunset over the sea"]


def test_noun_heuristic_equals_jax():
    for text in CAPTIONS:
        assert tnouns.extract_noun_phrase_heuristic(text) == \
            jnouns.extract_noun_phrase_heuristic(text), text


def test_extract_nouns_tool_equals_jax_at_one_and_two_workers(tmp_path, monkeypatch):
    """The heuristic path (no spaCy model here): --workers 1 and 2 write the
    same files, equal to keds_tpu's."""
    monkeypatch.setattr(tnouns, "_spacy_nlp", lambda: None)
    monkeypatch.setattr(jnouns, "_spacy_nlp", lambda: None)
    caps = {f"img{i:04d}.jpg": CAPTIONS[i % len(CAPTIONS)] + f" number {i}" for i in range(57)}
    (tmp_path / "caps.json").write_text(json.dumps(caps))
    outs = {}
    for name, mod, workers in (("t1", tnouns, 1), ("t2", tnouns, 2), ("j1", jnouns, 1)):
        out = tmp_path / name
        out.mkdir()
        mod.main(["--captions", str(tmp_path / "caps.json"), "--out-dir", str(out),
                  "--workers", str(workers)])
        outs[name] = [(out / f).read_bytes() for f in ("cc_subject.json", "cc_other.json")]
    assert outs["t1"] == outs["t2"] == outs["j1"]
    with pytest.raises(SystemExit, match="required but unavailable"):
        tnouns.main(["--captions", str(tmp_path / "caps.json"), "--out-dir", str(tmp_path),
                     "--require-spacy"])


def _val_tree(root, n=6):
    root.mkdir()
    for i in range(n):
        (root / f"ILSVRC2012_val_{i:08d}.JPEG").write_bytes(bytes([i]) * 5)
    lines = ["#!/bin/bash", "mkdir -p n01", "mkdir -p n02"]
    lines += [f"mv ILSVRC2012_val_{i:08d}.JPEG n0{1 + i % 2}/" for i in range(n + 2)]
    return "\n".join(lines) + "\n"


def _listing(root):
    return sorted((os.path.relpath(os.path.join(d, f), root), open(os.path.join(d, f), "rb").read())
                  for d, _, fs in os.walk(root) for f in fs)


def test_prep_imagenet_val_moves_as_jax(tmp_path, capsys):
    script = _val_tree(tmp_path / "t")
    _val_tree(tmp_path / "j")
    (tmp_path / "valprep.sh").write_text(script)
    assert tprep.parse_mapping(script.splitlines()) == jprep.parse_mapping(script.splitlines())
    assert tprep.parse_mapping(["a.JPEG n1", "# c", "b.JPEG n2/"]) == {"a.JPEG": "n1",
                                                                      "b.JPEG": "n2"}
    before = _listing(tmp_path / "t")
    assert tprep.main(["--val-dir", str(tmp_path / "t"), "--mapping",
                       str(tmp_path / "valprep.sh"), "--dry-run"]) == 0
    assert _listing(tmp_path / "t") == before
    assert "would move 6 files into 2 synset dirs (2 mapped files not present)" in \
        capsys.readouterr().out
    for mod, d in ((tprep, "t"), (jprep, "j")):
        assert mod.main(["--val-dir", str(tmp_path / d), "--mapping",
                         str(tmp_path / "valprep.sh")]) == 0
    assert _listing(tmp_path / "t") == _listing(tmp_path / "j")
    assert all(name.startswith(("n01/", "n02/")) for name, _ in _listing(tmp_path / "t"))


def test_image_folder_by_class_equals_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for c, n in (("zebra", 2), ("ant", 3), ("moth", 1)):
        (tmp_path / c).mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (8, 9, 3), np.uint8)).save(
                tmp_path / c / f"{c}{i}.png")
    (tmp_path / "stray.txt").write_text("not a class")
    t = tds.ImageFolderByClass(str(tmp_path), transform=np.asarray)
    j = jds.ImageFolderByClass(str(tmp_path), transform=np.asarray)
    assert t.samples == j.samples and t.targets == j.targets == [0, 0, 0, 1, 2, 2]
    assert t.class_to_idx == j.class_to_idx == {"ant": 0, "moth": 1, "zebra": 2}
    assert len(t) == len(j) == 6
    for i in range(6):
        (ti, tt), (ji, jt) = t[i], j[i]
        np.testing.assert_array_equal(ti, ji)
        assert tt == jt


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_imagenet_train_subset_indices_equal_jax(seed):
    targets = np.random.default_rng(seed + 50).integers(0, 12, 1300)
    for kw in ({}, {"per_class": 3, "n_classes": 12}, {"per_class": 500, "n_classes": 5}):
        got = tds.imagenet_train_subset_indices(targets, seed=seed, **kw)
        want = jds.imagenet_train_subset_indices(targets, seed=seed, **kw)
        np.testing.assert_array_equal(got, want)
        assert (np.diff(got) > 0).all()
    assert tds.imagenet_train_subset_indices([], seed=seed).shape == (0,)
