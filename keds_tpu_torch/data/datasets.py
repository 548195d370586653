"""Precomputed CC3M feature pairs, the training dataset (counterpart of
``FeaturePairDataset`` and ``build_other_tokens`` in
``keds_tpu/data/datasets.py``).

Two layouts: packed (``image_features.npy`` (N, D), ``text_features.npy``
(N, D) and ``names.json`` in one directory, memory-mapped) and the
reference's per-file one (``cc_image_feature_folder_clipl/*.pt`` and
``cc_text_feature_folder_clipl/*.pt``, read with ``torch.load``).  A sample
is ``(image_feature, caption_feature)`` as f32 arrays; with ``templates``
(the text stream) it is ``(image_feature, caption_feature, subject,
own_template_tokens)``, the tokens of ``"a photo of * * * " + other``
(stars in ``other`` blanked) from the ``cc_subject.json`` and
``cc_other.json`` maps in the folder.  Attached precomputed-neighbour
arrays add one int32 row each.  The image stream reads no vocab: only
templates are tokenized.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Sequence

import numpy as np
import torch

from keds_tpu_torch.tokenizer import tokenize


def _load_json_maybe(folder: str, name: str) -> dict:
    """``<folder>/<name>``, or {} where there is none."""
    path = os.path.join(folder, name)
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _read_pt_feature(path: str) -> np.ndarray:
    return torch.load(path, map_location="cpu", weights_only=True).float().numpy().reshape(-1)


class FeaturePairDataset:
    TEMPLATE_PREFIX = "a photo of * * * "

    def __init__(self, folder: str, templates: bool = False):
        self.folder = folder
        self.templates = templates
        packed_img = os.path.join(folder, "image_features.npy")
        if os.path.isfile(packed_img):
            self.mode = "packed"
            self.image_feats = np.load(packed_img, mmap_mode="r")
            self.text_feats = np.load(os.path.join(folder, "text_features.npy"), mmap_mode="r")
            with open(os.path.join(folder, "names.json")) as f:
                self.names = json.load(f)
        else:
            self.mode = "per-file"
            self.image_dir = os.path.join(folder, "cc_image_feature_folder_clipl")
            self.text_dir = os.path.join(folder, "cc_text_feature_folder_clipl")
            self.files = sorted(os.listdir(self.image_dir))
            self.names = [os.path.basename(f).split(".")[0] for f in self.files]
        self.subject: Dict[str, str] = {}
        self.other: Dict[str, str] = {}
        if templates:
            self.subject = _load_json_maybe(folder, "cc_subject.json")
            self.other = _load_json_maybe(folder, "cc_other.json")
        self.neighbors = None

    def features(self, lo: int, hi: int):
        """f32 (image, caption) features of samples ``lo:hi``, without the
        templates."""
        if self.mode == "packed":
            return (np.asarray(self.image_feats[lo:hi], np.float32),
                    np.asarray(self.text_feats[lo:hi], np.float32))
        return tuple(np.stack([_read_pt_feature(os.path.join(d, self.files[i]))
                               for i in range(lo, hi)])
                     for d in (self.image_dir, self.text_dir))

    def attach_neighbors(self, neighbors: tuple) -> None:
        """Attach precomputed-neighbour arrays (``(img_idx, txt_idx)`` for
        the image stream, ``(img_idx, txt_idx, cap2_idx)`` for the text
        stream), aligned with this dataset's sample order."""
        if any(len(a) != len(self.names) for a in neighbors):
            raise ValueError(
                f"neighbour pack rows {[len(a) for a in neighbors]} do not match "
                f"the dataset ({len(self.names)} samples)")
        self.neighbors = neighbors

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, idx: int):
        img, txt = (a[0] for a in self.features(idx, idx + 1))
        base = (img, txt)
        if self.templates:
            name = self.names[idx]
            other = self.other.get(name, "*")
            template = self.TEMPLATE_PREFIX + other.replace("*", " ")
            base += (self.subject.get(name, ""), tokenize(template)[0])
        if self.neighbors is not None:
            return base + tuple(np.asarray(a[idx], np.int32) for a in self.neighbors)
        return base


def build_other_tokens(names: Sequence[str], other: Dict[str, str],
                       template_prefix: str = "a photo of * * ") -> np.ndarray:
    """The neighbour templates ``template_prefix + other`` of every DB row,
    tokenized once, (N, 77) int32, so that the text-stream step gathers
    them by neighbour index.  Refuses a caption map that holds none of the
    DB's row names (the wrong map would train the neighbour term on bare
    prefixes)."""
    keys = [n.split(".")[0] for n in names]
    missing = sum(1 for k in keys if k not in other)
    if missing == len(names) and names:
        raise ValueError("none of the knowledge-DB row names appear in the 'other' "
                         "caption map (cc_other.json): wrong map for this DB?")
    if missing:
        logging.warning("%d/%d knowledge-DB rows have no 'other' caption entry; their "
                        "neighbour templates fall back to the bare prefix", missing,
                        len(names))
    return tokenize([template_prefix + other.get(k, "").replace("*", " ") for k in keys])
