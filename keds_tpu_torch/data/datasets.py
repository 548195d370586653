"""Precomputed CC3M feature pairs, the training dataset (counterpart of
``FeaturePairDataset`` in ``keds_tpu/data/datasets.py``), image stream.

The packed layout only: ``image_features.npy`` (N, D), ``text_features.npy``
(N, D) and ``names.json`` in one directory, memory-mapped.  A sample is
``(image_feature, caption_feature)`` as f32 arrays, plus one int32 row of
each attached precomputed-neighbour array (the image stream attaches
``img_idx`` and ``txt_idx``).  The reference's per-file layout and the tokenized
"a photo of * * * {other}" templates belong to the text stream, which needs
the BPE vocab, and are not ported yet.
"""

from __future__ import annotations

import json
import os

import numpy as np


class FeaturePairDataset:
    def __init__(self, folder: str):
        self.folder = folder
        packed_img = os.path.join(folder, "image_features.npy")
        if not os.path.isfile(packed_img):
            raise NotImplementedError(
                f"{folder}: only the packed layout (image_features.npy, "
                "text_features.npy, names.json) is ported; the per-file layout "
                "comes with the text stream (ROADMAP.md section A item 8)")
        self.image_feats = np.load(packed_img, mmap_mode="r")
        self.text_feats = np.load(os.path.join(folder, "text_features.npy"), mmap_mode="r")
        with open(os.path.join(folder, "names.json")) as f:
            self.names = json.load(f)
        self.neighbors = None

    def attach_neighbors(self, neighbors: tuple) -> None:
        """Attach precomputed-neighbour arrays (``(img_idx, txt_idx)`` for
        the image stream), aligned with this dataset's sample order."""
        if any(len(a) != len(self.names) for a in neighbors):
            raise ValueError(
                f"neighbour pack rows {[len(a) for a in neighbors]} do not match "
                f"the dataset ({len(self.names)} samples)")
        self.neighbors = neighbors

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, idx: int):
        base = (np.asarray(self.image_feats[idx], np.float32),
                np.asarray(self.text_feats[idx], np.float32))
        if self.neighbors is not None:
            return base + tuple(np.asarray(a[idx], np.int32) for a in self.neighbors)
        return base
